"""Scripts of the port run on the card: the convergence gate, the
determinism probe of the training step, and a probe of the CUDA
toolchain."""
