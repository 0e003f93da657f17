"""The benchmark of ``divergence_tpu_torch`` (``python -m gpubench.run``).

It imports nothing of JAX or of the JAX package ``divergence_tpu``; the
program under test is imported by :mod:`gpubench.scans` alone, and the
reference (:mod:`gpubench.reference`) imports nothing of it.
"""
