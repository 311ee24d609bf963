"""The pipeline stages of the port, one module per JAX stage module."""
