"""Scripts of the port: the convergence gate and its two diagnostics (the
overfit probe and the cost volume's signal at init), the determinism
probe of the training step, a probe of the CUDA toolchain, and the serving
export and HTTP server."""
