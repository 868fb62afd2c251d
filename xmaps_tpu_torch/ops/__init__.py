"""Per-frame tensor code and the wrappers of the CUDA kernels."""
