"""Command-line tools: ``python -m divergence_tpu_torch.tools.cli run-fet|run-css``."""
