"""Build, binding and launch counts of the port's CUDA kernels."""
