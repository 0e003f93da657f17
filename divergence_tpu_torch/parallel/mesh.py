"""Device meshes and window-axis shares (``divergence_tpu/parallel/mesh.py``).

A mesh is a tuple of ``torch.device``s; the window axis is cut into
contiguous shares, one per device.  Windows are embarrassingly parallel
(disjoint output slots, reference statistics/css/threadcss.c:262-269), so
no collective is needed for scoring; only the chromosome-level summary
statistics are summed (``sharded.py``).  A device may appear more than
once, which is how the CPU tests stand in for an 8-device mesh
(``devices=[cpu] * 8``) and how one card checks a 4-way split
(``[cuda:0] * 4``): the MC's shares run at once there too, a thread and a
stream each (``kernels/perm.py:_over_shares``), and the sharded step's, a
stream each, enqueued from the calling thread (``sharded.py``); the other
sharded loops enqueue one share after another.  JAX's ``replicated`` placement
has no counterpart: keys are ``[2]`` host tensors, copied to each device.
"""

from __future__ import annotations

import numpy as np
import torch

from divergence_tpu_torch import resolve_device

WINDOW_AXIS = "windows"


def make_mesh(n_devices: int | None = None, devices=None) -> tuple[torch.device, ...]:
    """1-D mesh over the window axis: every CUDA device by default, or the
    given ``devices`` (repeats allowed).  ``n_devices`` limits the mesh to
    the first n devices; asking for more than exist raises ValueError."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "make_mesh: torch.cuda.is_available() is False; pass devices= "
                "(e.g. [torch.device('cpu')]) to build a mesh of CPU devices"
            )
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return tuple(devices)


def window_slices(B: int, mesh) -> list[slice]:
    """The contiguous shares of ``B`` windows over the mesh, in device
    order: the first ``B % n`` devices take one window more (equal shares
    when ``n`` divides ``B``, as the sharded step requires)."""
    n = len(mesh)
    base, extra = divmod(B, n)
    out, lo = [], 0
    for i in range(n):
        hi = lo + base + (i < extra)
        out.append(slice(lo, hi))
        lo = hi
    return out


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (window batches must
    divide evenly over the mesh)."""
    return ((n + m - 1) // m) * m


def mesh_devices(device, sharding) -> tuple[torch.device, ...]:
    """The devices an engine runs on: the ``sharding`` mesh when one is
    given, else the one ``device``, else the card (``"cuda"``).  Raises
    when a CUDA device is asked for and none is present (there is no CPU
    fallback: the caller asks for the CPU with ``device="cpu"``)."""
    if sharding is not None:
        return tuple(resolve_device(d) for d in sharding)
    return (resolve_device("cuda" if device is None else device),)


def to_host(tensors: list, dim: int = 0) -> list:
    """numpy copies of ``tensors``, in order, with one device-to-host copy
    per device: the tensors of a device are concatenated along ``dim``
    first."""
    by_dev: dict = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    out = [None] * len(tensors)
    for idx in by_dev.values():
        parts = [tensors[i] for i in idx]
        packed = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)).cpu().numpy()
        cuts = np.cumsum([t.shape[dim] for t in parts])[:-1]
        for i, a in zip(idx, np.split(packed, cuts, axis=dim)):
            out[i] = a
    return out
