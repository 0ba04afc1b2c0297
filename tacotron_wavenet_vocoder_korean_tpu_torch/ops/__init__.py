"""See the JAX package's module of the same name."""
