"""The full divergence step over a device mesh
(``divergence_tpu/parallel/sharded.py``).

One step scores a padded window batch cut into contiguous shares, one per
mesh device.  Each device uploads its share once and runs, on its
windows, the FET score and bootstrap stddev (K10,
:func:`kernels.fet.fet_window_batch`), the CSS score and distance matrix
(:func:`kernels.css.css_window_batch`: K3, then K5 or K6) and one
fixed chunk of the permutation null (K11,
:func:`kernels.perm.permutation_chunk`), and sums its ``[2]`` float64
partial of the chromosome-level statistics.  The partials are summed in
shard order on the first device (the JAX step's one all-reduce), and the
per-window outputs are concatenated there in window order.

RNG: every stream is keyed by the window's slot, never by its batch or
shard position (``fold_in(key, 0)`` for FET, ``fold_in(key, 1)`` for the
SMACOF restarts, ``window_keys(fold_in(key, 2), 0, slot)`` for the MC
chunk), so the per-window outputs are bit-identical across mesh sizes and
sub-batch splits.
"""

from __future__ import annotations

import numpy as np
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import css as kcss
from divergence_tpu_torch.kernels import fet as kfet
from divergence_tpu_torch.kernels import perm as kperm
from divergence_tpu_torch.parallel.mesh import window_slices

OUTPUTS = ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits")


def _host(x, dtype=None) -> torch.Tensor:
    """``x`` (numpy or a tensor on any device) as a CPU tensor."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to("cpu", dtype) if dtype is not None else t.cpu()


def make_divergence_step(
    mesh,
    asize: int,
    bsize: int,
    *,
    percentile: float = 0.95,
    nsamples: int = 100,
    mds: int = 0,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
    mc_chunk: int = 128,
    drosophila: bool = False,
    plain: bool = False,
):
    """Build the sharded step over ``mesh`` (a ``make_mesh`` tuple).

    Returned callable signature::

        step(av, bv, npos, slot, key) -> dict

    with ``av``: [B, P, asize] genotype codes (or frequencies in
    drosophila mode), ``bv``: [B, P, bsize], ``npos``: [B] true SNP
    counts, ``slot``: [B] window identities (``start // wstep``; every
    stochastic stream is keyed off the slot), ``key``: a ``[2]`` PRNG key.
    The inputs may be numpy arrays or tensors on any device.  ``B`` must
    divide evenly by the mesh size.  Outputs on the mesh's first device:
    per-window ``fet_scores``, ``fet_stddev`` (float64), ``css_scores``
    (float64), ``css_valid`` (bool), ``mc_hits`` (int32), and the scalars
    ``windows_evaluated``, ``score_sum`` (float64).  ``plain=True`` runs
    every kernel's plain torch version on the same devices (the twin a card
    run is held against).  On the card the step takes any panel size: its
    MC chunk, K11 (``kperm.permutation_chunk``), runs its large-panel form
    past 64 individuals, and K10 its wide form on windows too wide for a
    block's shared memory."""
    devices = tuple(mesh)
    maxs = kfet.support_size(asize, bsize)
    nmax = asize + bsize + 2
    a_mc, b_mc = (1, 1) if drosophila else (asize, bsize)
    fet_fn = kfet.fet_window_batch_plain if plain else kfet.fet_window_batch
    chunk_fn = kperm.permutation_chunk_plain if plain else kperm.permutation_chunk

    def _share(dev, av, bv, npos, slot, k_fet, k_css, k_mc):
        av, bv = av.to(dev), bv.to(dev)
        fet_s, fet_d = fet_fn(
            av, bv, npos, float(percentile), k_fet, nsamples, maxs, nmax, slot=slot
        )
        css_s, dist, valid = kcss.css_window_batch(
            av, bv, npos, k_css, asize, bsize, drosophila=drosophila, mds=mds,
            smacof_iters=smacof_iters, smacof_inits=smacof_inits,
            smacof_eps=smacof_eps, slot=slot, plain=plain,
        )
        # one fixed chunk of the null per window, per-window streams
        npos_d, slot_d = npos.to(dev), slot.to(dev)
        # the constant folded in on the host: folded on the card, it is a
        # scalar uploaded from the host (a sync a share)
        keys = rng.fold_in(rng.fold_in(k_mc, 0).to(dev), slot_d)
        ones = torch.ones(npos.shape[0], dtype=torch.int32, device=dev)
        hits, _, _ = chunk_fn(dist, css_s, ones, mc_chunk, keys, a_mc, b_mc, mc_chunk)
        stats = torch.stack(
            [(npos_d > 0).to(torch.float64),
             torch.where(valid, css_s, 0.0).to(torch.float64)],
            dim=1,
        ).sum(dim=0)
        return (fet_s, fet_d, css_s, valid, hits), stats

    def step(av, bv, npos, slot, key) -> dict:
        av = av if torch.is_tensor(av) else torch.as_tensor(np.asarray(av))
        bv = bv if torch.is_tensor(bv) else torch.as_tensor(np.asarray(bv))
        B = av.shape[0]
        if B % len(devices):
            raise ValueError(
                f"the step's {B} windows do not divide over {len(devices)} devices"
            )
        npos = _host(npos, torch.int64)
        slot = _host(slot, torch.int64)
        key = _host(key, torch.int64)
        k_fet, k_css, k_mc = (rng.fold_in(key, i) for i in range(3))
        parts, partials = [], []
        for dev, sl in zip(devices, window_slices(B, devices)):
            out, stats = _share(dev, av[sl], bv[sl], npos[sl], slot[sl], k_fet, k_css,
                                k_mc)
            parts.append(out)
            partials.append(stats)
        first = devices[0]
        totals = partials[0].to(first)
        for p in partials[1:]:
            totals = totals + p.to(first)
        result = {
            name: torch.cat([part[i].to(first) for part in parts])
            for i, name in enumerate(OUTPUTS)
        }
        result["windows_evaluated"] = totals[0]
        result["score_sum"] = totals[1]
        return result

    return step
