"""Command-line tools: ``python -m divergence_tpu_torch.tools.cli
run-fet|run-css|run-all|filter-fet|call-css-regions|report|...``, and the
HTML report (``report.py``)."""
