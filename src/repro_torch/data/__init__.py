"""The token pipeline (the JAX package's ``data``)."""
