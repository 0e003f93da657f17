"""Top-2 eigenpairs of a batch of small symmetric matrices
(``divergence_tpu/kernels/linalg.py:top2_eig``).

The JAX package routes ``top2_eig`` by backend: batched Jacobi variants
on the TPU (lane-major, chunked; TPU workarounds), LAPACK ``eigh`` on the
CPU (``linalg.py:316-319``).  The port's plain version is the CPU route,
``torch.linalg.eigh``.  On the card the CMDS kernel (``csrc/css_cmds.cu``,
``css_common.cuh:cmds_embed``) takes the subset route of LAPACK's
``dsyevx`` instead: Householder reduction to tridiagonal form, the two
largest eigenvalues by multisection on Sturm counts, their vectors by
inverse iteration, the back-transform.  :func:`top2_eig_tridiag` runs
those steps in plain torch, batched; the tests hold it against LAPACK
before any card runs the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

EMBED_STEPS = 64      # multisection steps at most (css_common.cuh kEmbedSteps)
INVERSE_ITERS = 3     # solves of the inverse iteration (kInverseIters)
POINTS = 16           # Sturm counts per eigenvalue and step (a half-warp)


def top2_eig(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-2 eigenpairs (descending) of ``a`` ``[..., m, m]`` symmetric:
    (vals ``[..., 2]``, vecs ``[..., m, 2]``), the reference's "keep the
    dims largest eigenvalues" (reference statistics/css/css.c:543-553)."""
    w, v = torch.linalg.eigh(a)        # ascending
    return w.flip(-1)[..., :2], v.flip(-1)[..., :2]


def _householder(A: torch.Tensor):
    """dsytd2 (lower) on A [B, m, m] in place: (d [B, m], e [B, m-1],
    tau [B, m], V [B, m, m]) with reflector k's v in V[:, k+1:, k]
    (v_{k+1} = 1)."""
    B, m = A.shape[0], A.shape[-1]
    tau = A.new_zeros(B, m)
    e = A.new_zeros(B, max(m - 1, 1))
    V = A.new_zeros(B, m, m)
    for k in range(m - 2):
        alpha = A[:, k + 1, k]
        x = A[:, k + 2:, k]
        sigma = (x * x).sum(-1)
        nz = sigma != 0
        beta = -torch.copysign(torch.sqrt(alpha * alpha + sigma), alpha)
        tk = torch.where(nz, (beta - alpha) / beta, 0.0)
        scal = torch.where(nz, 1.0 / (alpha - beta), 0.0)
        v = torch.cat([torch.ones_like(alpha)[:, None], x * scal[:, None]], dim=-1)
        e[:, k] = torch.where(nz, beta, alpha)
        A22 = A[:, k + 1:, k + 1:]
        p = tk[:, None] * (A22 @ v[..., None])[..., 0]
        kk = 0.5 * tk * (p * v).sum(-1)
        w = p - kk[:, None] * v
        A[:, k + 1:, k + 1:] = A22 - (v[:, :, None] * w[:, None, :]
                                      + w[:, :, None] * v[:, None, :])
        V[:, k + 1:, k] = v
        tau[:, k] = tk
    d = torch.diagonal(A, dim1=-2, dim2=-1).clone()
    e[:, m - 2] = A[:, m - 1, m - 2]
    return d, e, tau, V


def _sturm(d: torch.Tensor, e2: torch.Tensor, x: torch.Tensor,
           pivmin: torch.Tensor) -> torch.Tensor:
    """dlaebz's count of eigenvalues of each T below x [B, ...]."""
    extra = (None,) * (x.dim() - 1)
    piv = pivmin[(slice(None),) + extra]
    q = d[(slice(None), 0) + extra] - x
    q = torch.where(q.abs() < piv, -piv, q)
    n = (q <= 0).to(torch.int64)
    for i in range(1, d.shape[1]):
        q = (d[(slice(None), i) + extra] - e2[(slice(None), i - 1) + extra] / q) - x
        q = torch.where(q.abs() < piv, -piv, q)
        n = n + (q <= 0)
    return n


def _multisect(d: torch.Tensor, e: torch.Tensor):
    """The two largest eigenvalues of T (d, e) [B, 2] by dstebz's
    multisection, 16 points a step, and the steps taken [B]."""
    B, m = d.shape
    dt = d.dtype
    eps, safmin = torch.finfo(dt).eps, torch.finfo(dt).tiny
    ae = e[:, : m - 1].abs()
    zero = d.new_zeros(B, 1)
    r = torch.cat([zero, ae], dim=1) + torch.cat([ae, zero], dim=1)
    glo, ghi = (d - r).amin(dim=1), (d + r).amax(dim=1)
    e2 = e[:, : m - 1] * e[:, : m - 1]
    pivmin = safmin * torch.clamp(e2.amax(dim=1), min=1.0)
    tnorm = torch.maximum(glo.abs(), ghi.abs())
    fudge = 2.1 * tnorm * eps * m
    glo = glo - fudge - 4.2 * pivmin
    ghi = ghi + fudge + 2.1 * pivmin
    atol, rtol = eps * tnorm, 2.0 * eps
    target = torch.tensor([m - 1, m - 2], device=d.device)
    lo = glo[:, None].expand(B, 2).clone()
    hi = ghi[:, None].expand(B, 2).clone()
    steps = torch.zeros(B, dtype=torch.int64, device=d.device)
    pts = torch.arange(1, POINTS + 1, dtype=dt, device=d.device)
    for _ in range(EMBED_STEPS):
        width = hi - lo
        tol = torch.maximum(atol[:, None], torch.maximum(
            pivmin[:, None], rtol * torch.maximum(lo.abs(), hi.abs())))
        conv = ~(width > tol)
        run = ~conv.all(dim=1)
        if not bool(run.any()):
            break
        steps = steps + run
        step = width / 17.0
        x = lo[..., None] + pts * step[..., None]                    # [B, 2, 16]
        above = _sturm(d, e2, x, pivmin) > target[None, :, None]
        anyb = above.any(dim=-1)
        f = torch.argmax(above.to(torch.int8), dim=-1).to(dt)
        nlo = torch.where(f > 0, lo + f * step, lo)
        nhi = lo + (f + 1) * step
        new_lo = torch.where(anyb, nlo, lo + 16.0 * step)
        new_hi = torch.where(anyb, nhi, hi)
        lo = torch.where(conv, lo, new_lo)
        hi = torch.where(conv, hi, new_hi)
    return 0.5 * (lo + hi), steps, tnorm


def _start_vectors(m: int, dtype, device) -> torch.Tensor:
    """[m, 2]: the fixed start vectors of css_common.cuh's start_entry."""
    i = np.arange(m, dtype=np.uint64)[:, None]
    c = np.arange(2, dtype=np.uint64)[None, :]
    h = ((i * 2 + c + 1) * 0x9E3779B9) & 0xFFFFFFFF
    h ^= h >> 15
    h = (h * 0x2C1B3C6D) & 0xFFFFFFFF
    h ^= h >> 12
    v = ((h >> 8).astype(np.int64) - (1 << 23)) / float(1 << 23)
    return torch.from_numpy(v).to(dtype=dtype, device=device)


def _tri_factor(d, e, lam, ptol):
    """dgttrf of T - lam I for every (window, vector) [B, 2, m], with
    dlagts' pivot floor ptol [B]."""
    B, m = d.shape
    dd = (d[:, None, :] - lam[..., None]).clone()
    du = e[:, None, : m - 1].expand(B, 2, m - 1).clone()
    dl = du.clone()
    du2 = torch.zeros_like(dd)
    pv = torch.zeros(B, 2, m, dtype=torch.bool, device=d.device)
    for i in range(m - 1):
        a, b = dd[..., i], dl[..., i]
        keep = a.abs() >= b.abs()
        safe = a != 0
        fact_k = torch.where(safe, b / torch.where(safe, a, 1.0), b)
        dd_next_k = torch.where(safe, dd[..., i + 1] - fact_k * du[..., i], dd[..., i + 1])
        fact_s = a / b
        dd_next_s = du[..., i] - fact_s * dd[..., i + 1]
        du_s = dd[..., i + 1]
        if i + 2 < m:
            du2[..., i] = torch.where(keep, 0.0, du[..., i + 1])
            du[..., i + 1] = torch.where(keep, du[..., i + 1], -fact_s * du[..., i + 1])
        dd[..., i] = torch.where(keep, a, b)
        dl[..., i] = torch.where(keep, fact_k, fact_s)
        du[..., i] = torch.where(keep, du[..., i], du_s)
        dd[..., i + 1] = torch.where(keep, dd_next_k, dd_next_s)
        pv[..., i] = ~keep
    p = ptol[:, None, None]
    dd = torch.where(dd.abs() < p, torch.where(dd < 0, -p, p), dd)
    return dd, du, du2, dl, pv


def _tri_solve(f, b):
    """dgttrs with tri_factor's factors on b [B, 2, m], then each vector
    scaled to unit 2-norm (by its largest entry first)."""
    dd, du, du2, dl, pv = f
    m = b.shape[-1]
    b = b.clone()
    for i in range(m - 1):
        bi, bn = b[..., i].clone(), b[..., i + 1].clone()
        b[..., i] = torch.where(pv[..., i], bn, bi)
        b[..., i + 1] = torch.where(pv[..., i], bi - dl[..., i] * bn, bn - dl[..., i] * bi)
    b[..., m - 1] = b[..., m - 1] / dd[..., m - 1]
    if m > 1:
        b[..., m - 2] = (b[..., m - 2] - du[..., m - 2] * b[..., m - 1]) / dd[..., m - 2]
    for i in range(m - 3, -1, -1):
        b[..., i] = (((b[..., i] - du[..., i] * b[..., i + 1]) - du2[..., i] * b[..., i + 2])
                     / dd[..., i])
    mx = b.abs().amax(dim=-1, keepdim=True)
    ok = mx > 0
    b = torch.where(ok, b / torch.where(ok, mx, 1.0), b)
    nrm = torch.sqrt((b * b).sum(dim=-1, keepdim=True))
    return torch.where(ok, b / nrm, b)


def top2_eig_tridiag(a: torch.Tensor, return_steps: bool = False):
    """Top-2 eigenpairs (descending) of ``a`` ``[..., m, m]`` symmetric,
    m >= 2, by the CMDS kernel's steps (``csrc/css_common.cuh``
    ``cmds_embed``): Householder tridiagonalisation, multisection of the
    two largest eigenvalues on Sturm counts, inverse iteration (the second
    vector re-orthogonalised against the first when the two lie within
    1e-3 |T|), the back-transform.  (vals ``[..., 2]``, vecs
    ``[..., m, 2]``), and with ``return_steps`` the multisection steps
    ``[...]``.  Eigenvector signs are arbitrary."""
    shape = a.shape[:-2]
    m = a.shape[-1]
    A = a.reshape(-1, m, m).clone()
    B, dt = A.shape[0], A.dtype
    eps, safmin = torch.finfo(dt).eps, torch.finfo(dt).tiny
    d, e, tau, V = _householder(A)
    lam, steps, tnorm = _multisect(d, e)
    close = (lam[:, 0] - lam[:, 1]) <= 1e-3 * tnorm
    ptol = torch.clamp(eps * tnorm, min=safmin)
    f = _tri_factor(d, e, lam, ptol)
    z = _start_vectors(m, dt, A.device).T[None].expand(B, 2, m).clone()
    for _ in range(INVERSE_ITERS):
        z = _tri_solve(f, z)
        z0, z1 = z[:, 0], z[:, 1]
        dot = (z0 * z1).sum(-1, keepdim=True)
        r = z1 - dot * z0
        r = r / torch.sqrt((r * r).sum(-1, keepdim=True))
        z = torch.stack([z0, torch.where(close[:, None], r, z1)], dim=1)
    q = z.transpose(1, 2).clone()                                    # [B, m, 2]
    for k in range(m - 3, -1, -1):
        v = V[:, k + 1:, k]                                          # [B, n]
        s = tau[:, k, None] * (v[..., None] * q[:, k + 1:]).sum(1)  # [B, 2]
        q[:, k + 1:] = q[:, k + 1:] - s[:, None, :] * v[..., None]
    vals = lam.reshape(*shape, 2)
    vecs = q.reshape(*shape, m, 2)
    if return_steps:
        return vals, vecs, steps.reshape(shape)
    return vals, vecs
