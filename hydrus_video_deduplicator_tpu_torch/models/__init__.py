"""Models of the port: the plain PyTorch PDQ pipeline, the device video
hasher, and the vision tower of the embedding rerank (``embed``, with the
CLIP checkpoint converter ``convert_clip``)."""
