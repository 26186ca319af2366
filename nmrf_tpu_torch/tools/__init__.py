"""Scripts that probe the CUDA toolchain and kernels on the card."""
