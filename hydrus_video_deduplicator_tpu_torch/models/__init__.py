"""Models of the port: the plain PyTorch PDQ pipeline and the device
video hasher."""
