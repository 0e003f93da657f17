"""Per-chromosome FET engine."""

from divergence_tpu_torch.engine.fet_engine import run_fet, run_fet_multi
from divergence_tpu_torch.engine.snp import SnpPair

__all__ = ["SnpPair", "run_fet", "run_fet_multi"]
