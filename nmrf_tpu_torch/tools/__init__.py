"""Scripts of the port: the convergence gate, the determinism probe of the
training step, a probe of the CUDA toolchain, and the serving export and
HTTP server."""
