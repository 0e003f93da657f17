"""The system under test, as a user's run drives it: one scan is one call
of ``divergence_tpu_torch.engine.run_css_multi`` or ``run_fet_multi`` (the
entries of ``run-css``, ``run-fet`` and ``run-all``) over a group of the
mix's chromosomes, each ``SnpPair`` built anew from the host arrays, so
that the upload is on the timed path.  Everything of the program is
imported here and nowhere else in the harness."""

from __future__ import annotations

import dataclasses

import numpy as np

from gpubench.reference.mc import decode
from gpubench.reference.windows import plan_windows
from gpubench.traffic import Chromosome


@dataclasses.dataclass
class Scan:
    outputs: dict          # seqid -> (scores, pvals or stddev), float64 [nslots]
    wall_s: float
    timings_s: dict        # RunSummary stages
    counters: dict         # RunSummary counters


def group_work(config: dict, kind: str, group: list[Chromosome], outputs: dict) -> dict:
    """What a scan of ``group`` does, from the windows and from the checked
    answers of its first scan (``outputs``; every later scan must equal
    them byte for byte): windows with SNPs, SNP tests (the SNPs of every
    such window) and, of a CSS scan, the windows scored (p > 0) and the
    permutations their p-values took (n of p = (hits + 1) / (n + 1) under
    the stop rule)."""
    windows = tests = 0
    for c in group:
        plan = plan_windows(c.positions, c.bp, config["wsize"], config["wstep"])
        ev = plan.evaluated()
        windows += int(ev.sum())
        tests += int(plan.npos[ev].sum())
    work = {"windows": windows, "snp_tests": tests}
    if kind == "css":
        p = np.concatenate([np.asarray(outputs[c.seqid][1], dtype=np.float64) for c in group])
        p = p[p > 0]
        _, n = decode(p, int(config["mc_runs"]), int(config["mc_threshold"]))
        work["scored"] = len(p)
        work["permutations"] = int(np.maximum(n, 0).sum())
    return work


def _fields(cls, config: dict) -> dict:
    """The configuration's values of ``cls``'s plain fields (the tool
    settings: MC cap and threshold, precision, streams, ...); the rest of
    the file (panel, SNP density, sources) is the generator's."""
    skip = {"window", "seed", "mds", "smacof"}
    return {f.name: config[f.name] for f in dataclasses.fields(cls)
            if f.name in config and f.name not in skip}


class Program:
    """The port's entry for a configuration and mix on ``device``, with the
    tool settings the configuration's file states (the library's defaults
    for the rest)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from divergence_tpu_torch.config import (CssConfig, FetConfig, MdsAlgorithm,
                                                 SmacofConfig, WindowConfig)
        from divergence_tpu_torch.engine import SnpPair, run_css_multi, run_fet_multi
        from divergence_tpu_torch.kernels import css as kcss
        from divergence_tpu_torch.kernels import fet as kfet
        from divergence_tpu_torch.kernels import perm as kperm
        from divergence_tpu_torch.utils.summary import RunSummary

        self._pair, self._summary = SnpPair, RunSummary
        self.device = device
        window = WindowConfig(wsize=config["wsize"], wstep=config["wstep"])
        if traffic["scan"] == "css":
            self._entry = run_css_multi
            self._cfg = CssConfig(
                window=window, seed=seed, mds=MdsAlgorithm[config["mds"].upper().replace("+", "_")],
                smacof=SmacofConfig(**config.get("smacof", {})), **_fields(CssConfig, config))
            self._launches = (kcss.LAUNCHES, kperm.LAUNCHES)
        elif traffic["scan"] == "fet":
            self._entry = run_fet_multi
            self._cfg = FetConfig(window=window, seed=seed, **_fields(FetConfig, config))
            self._launches = (kfet.LAUNCHES,)
        else:
            raise ValueError(f"unknown scan {traffic['scan']!r}")

    def launches(self) -> dict:
        """The kernel wrappers' launch counts so far, by wrapper."""
        return {k: v for counts in self._launches for k, v in counts.items()}

    def scan(self, group: list[Chromosome], clock) -> Scan:
        summary = self._summary()
        t0 = clock()
        pairs = {c.seqid: (self._pair(positions=c.positions, avals=c.avals, bvals=c.bvals),
                           c.bp) for c in group}
        out = self._entry(pairs, self._cfg, device=self.device, summary=summary)
        wall = clock() - t0
        return Scan(outputs=out, wall_s=wall, timings_s=dict(summary.timings_s),
                    counters=dict(summary.counters))


def same_outputs(a: dict, b: dict) -> bool:
    """Byte-equal outputs of two scans of one group."""
    return a.keys() == b.keys() and all(
        np.array_equal(x, y, equal_nan=True) for k in a for x, y in zip(a[k], b[k]))
