"""Host-side window planning (copied from the JAX package)."""

from divergence_tpu_torch.core.windows import WindowPlan, plan_windows

__all__ = ["WindowPlan", "plan_windows"]
