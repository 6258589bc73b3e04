"""Build support for the port's hand-written CUDA kernels."""
