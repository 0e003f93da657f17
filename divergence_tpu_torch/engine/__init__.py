"""Per-chromosome FET and CSS engines."""

from divergence_tpu_torch.engine.css_engine import run_css, run_css_multi
from divergence_tpu_torch.engine.fet_engine import run_fet, run_fet_multi
from divergence_tpu_torch.engine.snp import SnpPair

__all__ = ["SnpPair", "run_css", "run_css_multi", "run_fet", "run_fet_multi"]
