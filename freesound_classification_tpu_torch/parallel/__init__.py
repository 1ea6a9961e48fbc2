"""Data parallel across ranks (JAX ``parallel/``)."""
