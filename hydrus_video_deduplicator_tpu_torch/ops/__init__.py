"""Device ops of the port: hash primitives, the segment sweep and its CUDA
kernel, and the exact pair verification."""
