"""Weight carry-over between the JAX package and the port."""
