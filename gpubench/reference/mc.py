"""Plain reference of the CSS permutation p-values on the shared stream
(``divergence_tpu_torch/kernels/perm.py``, ``CssConfig(mc_stream="shared",
rng="mix")``): chunk k of ``chunk`` permutations is ranked from the words
``mix_bits(fold_in(fold_in(PRNGKey(seed), 2), k), chunk * m)`` (element
(K, j) is word K*m + j; rank = position in the stable ascending order), and
permutation K's score of a window is ``sum C_K[j, l] D[j, l]`` with
C[j, l] = u_j (1 - u_l) / (a b) - (a + b) w(r_j) 1[r_l = r_j + 1], u_j =
1[r_j < a]: the CSS of the window's distances with the labels permuted.
A window stops at its ``threshold``-th permutation whose score is >= the
observed one, or at ``runs``; p = (hits + 1) / (n + 1).

:func:`bands` judges a program's (hits, n): the smallest band t, in units
of the window's ``scale``, within which a score may count on either side
of the observed one so that the program's hits and stop are what the
reference's scores give.  :func:`significance` runs the estimator itself
(the reference's own answers, and the control's in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import rng

BLOCK_CHUNKS = 16          # chunks of permutations scored at once
BLOCK_ELEMS = 1 << 26      # at most this many coefficients built at once


def mc_key(seed: int, device) -> torch.Tensor:
    return rng.fold_in(rng.prng_key(seed), 2).to(device)


def ranks(key: torch.Tensor, k0: int, nk: int, chunk: int, m: int) -> torch.Tensor:
    """[nk * chunk, m] int64: rank of individual j in permutation (k, K)."""
    kc = rng.fold_in(key, torch.arange(k0, k0 + nk, device=key.device))   # [nk, 2]
    words = rng.mix_bits(kc, chunk * m).reshape(nk * chunk, m)
    order = torch.sort(words, dim=1, stable=True).indices
    r = torch.empty_like(order)
    r.scatter_(1, order, torch.arange(m, device=key.device).expand_as(order).contiguous())
    return r


def coefficients(r: torch.Tensor, asize: int, bsize: int, dtype: torch.dtype) -> torch.Tensor:
    """[m*m, K] coefficient columns of ranks r [K, m]."""
    m = asize + bsize
    wa = 1.0 / (asize * asize * (asize - 1)) if asize > 1 else 0.0
    wb = 1.0 / (bsize * bsize * (bsize - 1)) if bsize > 1 else 0.0
    u = r < asize
    between = (u[:, :, None] & ~u[:, None, :]).to(dtype) / (asize * bsize)
    cw = torch.where(r < asize - 1, m * wa,
                     torch.where((r >= asize) & (r < m - 1), m * wb, 0.0)).to(dtype)
    adj = r[:, None, :] == r[:, :, None] + 1                      # [K, j, l]
    C = between - adj.to(dtype) * cw[:, :, None]
    return C.reshape(r.shape[0], m * m).T


def _blocks(runs: int, chunk: int, m: int):
    """(first chunk, chunks) of each block of permutations up to ``runs``."""
    per = max(1, min(BLOCK_CHUNKS, BLOCK_ELEMS // (m * m * chunk)))
    n_chunks = -(-runs // chunk)
    for k0 in range(0, n_chunks, per):
        yield k0, min(per, n_chunks - k0)


def bands(dist: torch.Tensor, obs: torch.Tensor, scale: torch.Tensor, hits: np.ndarray,
          nsc: np.ndarray, seed: int, asize: int, bsize: int, chunk: int, runs: int,
          threshold: int) -> np.ndarray:
    """The band t [W] each program answer (hits, nsc) needs, from the
    reference's dist [W, m, m] and observed scores obs [W] (float64) on
    their device; inf where no band explains it (n past ``runs``, fewer
    than ``threshold`` hits before ``runs``, hits past ``threshold``).

    With margins x = (score - obs) / scale of the permutations that count
    (those before the stop, or all ``runs`` without one) sorted
    descending, c hits among them need t >= x_(c+1) (no more can be
    certain) and t >= -x_(c) (enough can be); a stop at n needs permutation
    n to be a possible hit, t >= -x_n."""
    dev = dist.device
    W, m = dist.shape[0], asize + bsize
    hits = np.asarray(hits, dtype=np.int64)
    nsc = np.asarray(nsc, dtype=np.int64)
    t = np.zeros(W)
    bad = (nsc < 1) | (nsc > runs) | (hits < 0) | (hits > threshold) | (
        (hits < threshold) & (nsc != runs))
    t[bad] = np.inf
    stop = ~bad & (hits == threshold)
    # permutations counted, and how many hits among them
    limit = np.where(stop, nsc - 1, nsc)
    c = np.where(stop, hits - 1, hits)
    lim_d = torch.as_tensor(limit, device=dev)
    nsc_d = torch.as_tensor(nsc, device=dev)
    k = threshold + 1
    top = torch.full((W, k), float("-inf"), dtype=torch.float64, device=dev)
    at_stop = torch.full((W,), float("inf"), dtype=torch.float64, device=dev)
    flat = dist.reshape(W, m * m).to(torch.float64)
    key = mc_key(seed, dev)
    need = int(max(nsc[~bad].max(), 1)) if (~bad).any() else 0
    for k0, nk in _blocks(need, chunk, m):
        g0 = k0 * chunk
        rows = torch.nonzero(torch.as_tensor(~bad, device=dev) & (nsc_d > g0))[:, 0]
        if rows.numel() == 0:
            continue
        C = coefficients(ranks(key, k0, nk, chunk, m), asize, bsize, torch.float64)
        x = (flat[rows] @ C - obs[rows, None]) / scale[rows, None]      # [A, nk*chunk]
        g = g0 + torch.arange(x.shape[1], device=dev)[None, :]
        counted = torch.where(g < lim_d[rows, None], x, float("-inf"))
        top[rows] = torch.topk(torch.cat([top[rows], counted], 1), k, dim=1).values
        hit_col = nsc_d[rows] - 1 - g0
        inside = (hit_col >= 0) & (hit_col < x.shape[1])
        sel = rows[inside]
        at_stop[sel] = x[inside, hit_col[inside]]
    top = top.cpu().numpy()
    at_stop = at_stop.cpu().numpy()
    ok = ~bad
    idx = np.arange(W)
    # x_(c+1) and x_(c) from the running top k (c <= threshold - 1 + 1)
    nxt = top[idx, np.clip(c, 0, k - 1)]
    cur = np.where(c >= 1, top[idx, np.clip(c - 1, 0, k - 1)], np.inf)
    tt = np.maximum(0.0, np.maximum(np.where(np.isfinite(nxt), nxt, -np.inf), -cur))
    tt = np.where(stop, np.maximum(tt, -at_stop), tt)
    t[ok] = tt[ok]
    return t


def significance(dist: torch.Tensor, obs: torch.Tensor, seed: int, asize: int, bsize: int,
                 chunk: int, runs: int, threshold: int,
                 prec: str = "f64") -> tuple[np.ndarray, np.ndarray]:
    """(hits, n) [W] of the estimator on dist [W, m, m] and obs [W]:
    float64, or ``prec="bf16"`` (products of bfloat16 distances and
    coefficients, scores and observed scores rounded to bfloat16)."""
    dev = dist.device
    W, m = dist.shape[0], asize + bsize
    if prec == "bf16":
        flat = dist.reshape(W, m * m).to(torch.bfloat16)
        obs = obs.to(torch.bfloat16).to(torch.float32)
    else:
        flat = dist.reshape(W, m * m).to(torch.float64)
    hits = torch.zeros(W, dtype=torch.int64, device=dev)
    nsc = torch.zeros(W, dtype=torch.int64, device=dev)
    done = torch.zeros(W, dtype=torch.bool, device=dev)
    key = mc_key(seed, dev)
    for k0, nk in _blocks(runs, chunk, m):
        rows = torch.nonzero(~done)[:, 0]
        if rows.numel() == 0:
            break
        r = ranks(key, k0, nk, chunk, m)
        if prec == "bf16":
            C = coefficients(r, asize, bsize, torch.float32).to(torch.bfloat16)
            s = (flat[rows] @ C).to(torch.float32)
        else:
            s = flat[rows] @ coefficients(r, asize, bsize, torch.float64)
        g = k0 * chunk + torch.arange(s.shape[1], device=dev)[None, :]
        hit = (s >= obs[rows, None]) & (g < runs)
        cum = hits[rows, None] + torch.cumsum(hit.to(torch.int64), 1)
        reached = cum[:, -1] >= threshold
        pos = torch.argmax((cum >= threshold).to(torch.int8), 1)
        hits[rows] = torch.where(reached, threshold, cum[:, -1])
        counted = int(min(runs, (k0 + nk) * chunk))
        nsc[rows] = torch.where(reached, g[0, pos] + 1, counted)
        done[rows] = reached
    return hits.cpu().numpy(), nsc.cpu().numpy()


def decode(p: np.ndarray, runs: int, threshold: int) -> tuple[np.ndarray, np.ndarray]:
    """(hits, n) of p = (hits + 1) / (n + 1) under the stop rule: n < runs
    only with hits = threshold; (-1, -1) where p is no such ratio."""
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        n_stop = (threshold + 1) / p - 1.0
        h_cap = p * (runs + 1) - 1.0
        ns = np.rint(n_stop)
        hc = np.rint(h_cap)
        stop_ok = np.isfinite(n_stop) & (np.abs(n_stop - ns) < 1e-6 * np.maximum(ns, 1)) & (
            ns >= 1) & (ns <= runs)
        cap_ok = np.isfinite(h_cap) & (np.abs(h_cap - hc) < 1e-6) & (hc >= 0) & (
            hc <= threshold)
    hits = np.where(stop_ok, threshold, np.where(cap_ok, hc, -1)).astype(np.int64)
    nsc = np.where(stop_ok, ns, np.where(cap_ok, runs, -1)).astype(np.int64)
    return hits, nsc
