"""Run summaries (copied from the JAX package)."""
