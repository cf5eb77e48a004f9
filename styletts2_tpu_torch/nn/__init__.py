"""Tensor primitives with the JAX package's numerics (biased variances, eps
inside the square root, packed-sequence LSTM semantics)."""
