"""Device ops of the port: the PDQ filter and its CUDA kernel, hash
primitives, the segment sweep and its CUDA kernel, and the exact pair
verification."""
