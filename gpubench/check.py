"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``gpubench/reference``), each number
beside its limit from ``gpubench/checks/<workload>.json``.

CSS (every evaluated window's slot; the scores and MC answers of the
windows the rules name):

* ``css_valid_mismatch`` — slots where the program's valid flag (p > 0)
  differs from the reference's (SNPs in the window, not discarded), or an
  invalid slot holds a nonzero score or p; exact, limit 0.
* ``css_score_gap`` — the widest |score - reference| over the window's
  scale (the reference's mean between-group distance), over the windows
  whose 2-D embedding is defined to rounding: eigengap (l2 - l3) / |l1|
  of the reference at least ``eigengap_min`` (the rule leaves out windows
  where the embedding turns freely; their count is printed).
* ``mc_band`` — the widest band (same scale) within which permuted scores
  must be allowed to fall on either side of the observed one for the
  program's (hits, n), decoded from p, to follow from the reference's
  scores (:func:`gpubench.reference.mc.bands`); inf for a p that no
  (hits, n) gives.

FET: ``fet_score_gap`` and ``fet_stddev_gap``, the widest |value -
reference| / max(|reference|, 1) over every slot (scores) and over the
sampled windows (stddev).

Both: ``repeat_mismatch``, the scans in the window whose outputs are not
byte-equal to the first scan of their chromosomes; exact, limit 0.

A check file (``gpubench/checks/<workload>.json``) holds the rules and
limits; the mix's ``scan`` picks the judge.
"""

from __future__ import annotations

import json
import math
import types
from pathlib import Path

import numpy as np
import torch

from gpubench.reference import css as rcss
from gpubench.reference import fet as rfet
from gpubench.reference import mc as rmc
from gpubench.reference.windows import plan_windows
from gpubench.traffic import Chromosome


def load_rules(root: Path, workload: str) -> dict:
    return json.loads((root / "gpubench" / "checks" / f"{workload}.json").read_text())


def _sample(ids: np.ndarray, n, seed: int, salt: int) -> np.ndarray:
    if n is None or len(ids) <= n:
        return ids
    rng = np.random.default_rng([int(seed) % (1 << 64), salt])
    return np.sort(rng.choice(ids, size=int(n), replace=False))


def _gap(got: np.ndarray, ref: np.ndarray, scale: np.ndarray) -> float:
    """Widest |got - ref| / scale; NaN on one side only is inf."""
    if len(ref) == 0:
        return 0.0
    both_nan = np.isnan(got) & np.isnan(ref)
    d = np.abs(got - ref) / scale
    d = np.where(both_nan, 0.0, np.where(np.isnan(d), np.inf, d))
    return float(d.max())


# the CSS settings this reference computes (absent keys take the library's
# defaults, which are these)
CSS_MODELLED = {"mds": "cmds", "mc_stream": "shared", "rng": "mix", "p_mode": "mc",
                "perm_backend": "xla", "drosophila": False}


def _modelled(config: dict) -> None:
    for key, value in CSS_MODELLED.items():
        if config.get(key, value) != value:
            raise ValueError(f"the CSS reference models {key}={value!r}, not {config[key]!r}")


def css_numbers(config: dict, rules: dict, chroms: list[Chromosome], outputs: dict,
                seed: int, device) -> dict:
    """The CSS numbers of ``outputs`` (seqid -> (scores, pvals)) against the
    reference on ``device``, with what the rules left out."""
    _modelled(config)
    a, b = int(config["asize"]), int(config["bsize"])
    thr, runs, chunk = int(config["mc_threshold"]), int(config["mc_runs"]), int(config["mc_chunk"])
    res = {"css_valid_mismatch": 0, "css_score_gap": 0.0, "mc_band": 0.0}
    info = {"windows_scored": 0, "eigengap_excluded": 0, "mc_windows": 0}
    for ci, c in enumerate(chroms):
        sc, pv = (np.asarray(x, dtype=np.float64) for x in outputs[c.seqid])
        plan = plan_windows(c.positions, c.bp, config["wsize"], config["wstep"])
        ev = np.nonzero(plan.evaluated())[0]
        codes = torch.as_tensor(np.concatenate([c.avals, c.bvals], 1), device=device)
        # the valid flags of every window (counts and the discard rule only)
        keep = rcss.kept(codes, plan.lo[ev], plan.npos[ev], a + b)
        valid_ref = np.zeros(len(sc), bool)
        valid_ref[plan.slot[ev[keep]]] = True
        valid_prog = pv > 0
        res["css_valid_mismatch"] += int((valid_ref != valid_prog).sum()) + int(
            ((~valid_ref) & ((sc != 0) | (pv != 0))).sum())
        ids = ev[keep]
        info["windows_scored"] += len(ids)
        ids = _sample(ids, rules.get("phase1_windows"), seed, 2 * ci)
        score, dist, _, gap = rcss.phase1(codes, plan.lo[ids], plan.npos[ids], a, b)
        del codes
        scale = dist[:, :a, a:].mean(dim=(-1, -2))
        ok = (gap >= rules["eigengap_min"]).cpu().numpy() & valid_prog[plan.slot[ids]]
        info["eigengap_excluded"] += int((~ok).sum())
        slots = plan.slot[ids][ok]
        res["css_score_gap"] = max(res["css_score_gap"], _gap(
            sc[slots], score.cpu().numpy()[ok], scale.cpu().numpy()[ok]))
        mc_ids = np.nonzero(ok)[0]
        mc_ids = _sample(mc_ids, rules.get("mc_windows"), seed, 2 * ci + 1)
        hits, nsc = rmc.decode(pv[plan.slot[ids][mc_ids]], runs, thr)
        sel = torch.as_tensor(mc_ids, device=dist.device)
        t = rmc.bands(dist[sel], score[sel], scale[sel], hits, nsc, seed, a, b, chunk, runs, thr)
        info["mc_windows"] += len(mc_ids)
        res["mc_band"] = max(res["mc_band"], float(t.max()) if len(t) else 0.0)
    return {**res, **info}


def fet_numbers(config: dict, rules: dict, chroms: list[Chromosome], outputs: dict,
                seed: int, device) -> dict:
    res = {"fet_score_gap": 0.0, "fet_stddev_gap": 0.0}
    info = {"windows_evaluated": 0, "stddev_windows": 0}
    tie = rfet.tie_rtol(config["precision"])
    rdt = rfet.rank_dtype(config["precision"])
    for ci, c in enumerate(chroms):
        sc, sd = (np.asarray(x, dtype=np.float64) for x in outputs[c.seqid])
        plan = plan_windows(c.positions, c.bp, config["wsize"], config["wstep"])
        ev = np.nonzero(plan.evaluated())[0]
        info["windows_evaluated"] += len(ev)
        per_snp = rfet.snp_scores(c.avals, c.bvals, device, tie)
        key = rfet.chromosome_key(seed, c.seqid)
        ref_sc, _ = rfet.window_scores(per_snp, plan, config["percentile"], 1, key, ev, rdt)
        want = np.zeros(len(sc))
        want[plan.slot[ev]] = ref_sc.cpu().numpy()
        res["fet_score_gap"] = max(res["fet_score_gap"],
                                   _gap(sc, want, np.maximum(np.abs(want), 1.0)))
        ids = _sample(ev, rules.get("stddev_windows"), seed, ci)
        _, ref_sd = rfet.window_scores(per_snp, plan, config["percentile"],
                                       config["bootstrap_samples"], key, ids, rdt)
        ref_sd = ref_sd.cpu().numpy()
        info["stddev_windows"] += len(ids)
        res["fet_stddev_gap"] = max(res["fet_stddev_gap"], _gap(
            sd[plan.slot[ids]], ref_sd, np.maximum(np.abs(ref_sd), 1.0)))
    return {**res, **info}


def numbers(kind: str, config: dict, rules: dict, chroms, outputs, seed, device) -> dict:
    return JUDGES[kind].numbers(config, rules, chroms, outputs, seed, device)


def control_outputs(kind: str, config: dict, rules: dict, chroms, seed, device,
                    prec: str = "bf16") -> dict:
    """The reference put in the program's place: its outputs computed in
    ``prec`` (the control: bfloat16; ``"f64"``: the reference's own)."""
    return JUDGES[kind].control_outputs(config, rules, chroms, seed, device, prec)


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number at or
    under its limit."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        v = nums[name]
        shown[name] = {"value": v if math.isfinite(v) else str(v), "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, shown


# ---------------------------------------------------------------- control


def css_control(config: dict, rules: dict, chroms: list[Chromosome], seed: int, device,
                prec: str) -> dict:
    """:func:`control_outputs` of CSS, for the windows the check compares
    (the same samples); every other valid window gets p = 1, which only
    its flag is read for."""
    _modelled(config)
    a, b = int(config["asize"]), int(config["bsize"])
    out = {}
    for ci, c in enumerate(chroms):
        plan = plan_windows(c.positions, c.bp, config["wsize"], config["wstep"])
        ev = np.nonzero(plan.evaluated())[0]
        scores, pvals = np.zeros(plan.nslots), np.zeros(plan.nslots)
        codes = torch.as_tensor(np.concatenate([c.avals, c.bvals], 1), device=device)
        kept = ev[rcss.kept(codes, plan.lo[ev], plan.npos[ev], a + b)]
        pvals[plan.slot[kept]] = 1.0
        ids = _sample(kept, rules.get("phase1_windows"), seed, 2 * ci)
        score, dist, _, _ = rcss.phase1(codes, plan.lo[ids], plan.npos[ids], a, b, prec)
        hits, nsc = rmc.significance(dist, score, seed, a, b, config["mc_chunk"],
                                     config["mc_runs"], config["mc_threshold"], prec)
        scores[plan.slot[ids]] = score.cpu().numpy()
        pvals[plan.slot[ids]] = (hits + 1.0) / (nsc + 1.0)
        out[c.seqid] = (scores, pvals)
    return out


def fet_control(config: dict, rules: dict, chroms: list[Chromosome], seed: int, device,
                prec: str) -> dict:
    """:func:`control_outputs` of FET: every window's score, the sampled
    windows' stddev (0 elsewhere, which is not read)."""
    out = {}
    rdt = rfet.rank_dtype(config["precision"])
    for ci, c in enumerate(chroms):
        plan = plan_windows(c.positions, c.bp, config["wsize"], config["wstep"])
        ev = np.nonzero(plan.evaluated())[0]
        scores, stddev = np.zeros(plan.nslots), np.zeros(plan.nslots)
        per_snp = rfet.snp_scores(c.avals, c.bvals, device, rfet.tie_rtol(config["precision"]),
                                  prec)
        key = rfet.chromosome_key(seed, c.seqid)
        sc, _ = rfet.window_scores(per_snp, plan, config["percentile"], 1, key, ev, rdt, prec)
        ids = _sample(ev, rules.get("stddev_windows"), seed, ci)
        _, sd = rfet.window_scores(per_snp, plan, config["percentile"],
                                   config["bootstrap_samples"], key, ids, rdt, prec)
        scores[plan.slot[ev]] = sc.cpu().numpy()
        stddev[plan.slot[ids]] = sd.cpu().numpy()
        out[c.seqid] = (scores, stddev)
    return out


JUDGES = {"css": types.SimpleNamespace(numbers=css_numbers, control_outputs=css_control),
          "fet": types.SimpleNamespace(numbers=fet_numbers, control_outputs=fet_control)}
