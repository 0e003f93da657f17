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

The shares run at once, as the JAX step's one jitted GSPMD program runs
on every device: on CUDA each is enqueued from the calling thread on a
stream of its own (the sharded MC's stream per (device, share),
``kernels/perm.py:_on_share``), and nothing in a share waits for the
card.  Its host rows (``npos``, ``slot``, the MC key's two words; the
codes too where they come from the host) go up in one copy from pinned
memory before its first launch (:func:`_upload`); the wrappers read the
host copies for every decision they make on the host.  The caller's
stream waits for every share's stream before the gather.

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
from divergence_tpu_torch.kernels._cuda import is_cpu
from divergence_tpu_torch.parallel.mesh import window_slices

OUTPUTS = ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits")
# byte alignment of each tensor in a share's pinned upload
_ALIGN = 256


def _host(x, dtype=None) -> torch.Tensor:
    """``x`` (numpy or a tensor on any device) as a CPU tensor."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to("cpu", dtype) if dtype is not None else t.cpu()


def _pack(tensors: list, pin: bool) -> tuple[torch.Tensor, list]:
    """``tensors`` copied into one byte buffer, pinned where ``pin``, each
    at an offset aligned to ``_ALIGN`` bytes: (buffer, each one's
    (offset, bytes, dtype, shape)), which :func:`_unpack` reads back."""
    layout, total = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        layout.append((total, nbytes, t.dtype, t.shape))
        total += -(-nbytes // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    for t, view in zip(tensors, _unpack(buf, layout)):
        view.copy_(t)
    return buf, layout


def _unpack(buf: torch.Tensor, layout: list) -> list:
    """The tensors of :func:`_pack`'s ``layout``, as views of ``buf``."""
    return [buf[off:off + nbytes].view(dtype).view(shape)
            for off, nbytes, dtype, shape in layout]


def _upload(dev: torch.device, tensors: list) -> list:
    """Host ``tensors`` on ``dev``, in order.  On CUDA they are packed into
    one pinned buffer (:func:`_pack`) and sent by one non-blocking copy on
    the current stream, so the host goes on at once (a copy from pageable
    memory waits for the stream to drain); each comes back as a view of
    the copy.  The host allocator keeps the pinned block until the copy
    is done.  On the CPU they are returned as they are."""
    if is_cpu(dev):
        return list(tensors)
    buf, layout = _pack(tensors, pin=True)
    return _unpack(buf.to(dev, non_blocking=True), layout)


def _place(dev: torch.device, stream, *tensors) -> list:
    """A share's inputs on ``dev``, for use on ``stream`` (None on the
    CPU): every host tensor through one :func:`_upload`; a tensor already
    on ``dev`` as it is, its use on ``stream`` recorded, so its memory is
    not reused before that stream is done with it; a tensor on another
    card copied on that card's current stream (torch's cross-device copy
    then makes ``stream`` wait for it)."""
    out = list(tensors)
    host = [j for j, t in enumerate(out) if t.device.type == "cpu"]
    for j, t in zip(host, _upload(dev, [out[j] for j in host])):
        out[j] = t
    for j, t in enumerate(out):
        if j in host:
            continue
        if t.device == dev:
            if stream is not None:
                t.record_stream(stream)
        else:
            out[j] = t.to(dev)
    return out


def _gather(shares, first: torch.device, made) -> dict:
    """The step's result on ``first`` from each share's (stream, (outputs,
    stats)): ``made``, the caller's stream there (None on the CPU), waits
    for every share's stream first; a share's tensor on ``first`` is read
    as it is, its use on ``made`` recorded; one on another card is copied
    on that card's share stream, after the share's work."""
    for stream, _ in shares:
        if stream is not None:
            made.wait_stream(stream)

    def to_first(t, stream):
        if t.device == first:
            if stream is not None:
                t.record_stream(made)
            return t
        with torch.cuda.stream(stream):
            return t.to(first)

    totals = None
    for stream, (_, stats) in shares:
        p = to_first(stats, stream)
        totals = p if totals is None else totals + p
    result = {
        name: torch.cat([to_first(out[i], stream) for stream, (out, _) in shares])
        for i, name in enumerate(OUTPUTS)
    }
    result["windows_evaluated"] = totals[0]
    result["score_sum"] = totals[1]
    return result


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
    chunk_fn = kperm.permutation_chunk_plain if plain else kperm.permutation_chunk

    def _share(dev, stream, av, bv, npos, slot, k_fet, k_css, k_mc):
        n = npos.shape[0]
        av, bv, rows = _place(dev, stream, av, bv, torch.cat([npos, slot, k_mc]))
        npos_d, slot_d, k_mc = rows[:n], rows[n:2 * n], rows[2 * n:]
        if plain:
            fet_s, fet_d = kfet.fet_window_batch_plain(
                av, bv, npos_d, float(percentile), k_fet, nsamples, maxs, nmax, slot=slot_d
            )
        else:
            fet_s, fet_d = kfet.fet_window_batch(
                av, bv, npos, float(percentile), k_fet, nsamples, maxs, nmax, slot=slot,
                npos_d=npos_d, slot_d=slot_d,
            )
        css_s, dist, valid = kcss.css_window_batch(
            av, bv, npos, k_css, asize, bsize, drosophila=drosophila, mds=mds,
            smacof_iters=smacof_iters, smacof_inits=smacof_inits,
            smacof_eps=smacof_eps, slot=slot, plain=plain, npos_d=npos_d, slot_d=slot_d,
        )
        # one fixed chunk of the null per window, per-window streams
        keys = rng.fold_in(k_mc, slot_d)
        ones = torch.ones(n, dtype=torch.int32, device=dev)
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
        # the MC's constant folded in on the host: its words go up with
        # each share's rows
        k_mc = rng.fold_in(k_mc, 0)
        first = devices[0]
        made = None if is_cpu(first) else torch.cuda.current_stream(first)
        shares = []
        for i, (dev, sl) in enumerate(zip(devices, window_slices(B, devices))):
            with kperm._on_share(i, dev, made) as stream:
                shares.append((stream, _share(dev, stream, av[sl], bv[sl], npos[sl], slot[sl],
                                              k_fet, k_css, k_mc)))
        return _gather(shares, first, made)

    return step
