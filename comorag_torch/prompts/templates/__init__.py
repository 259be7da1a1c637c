"""Copy of ``comorag_tpu/prompts/templates/__init__.py`` for the port, which imports nothing of the JAX package."""
