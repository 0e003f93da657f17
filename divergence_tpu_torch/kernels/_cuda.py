"""Launch plumbing shared by the kernel wrappers of ``kernels/``.

A wrapper decides by its tensor's device: a CPU tensor runs the plain
torch version, a CUDA tensor launches the kernel from the library that
``_build`` compiles (there is no fallback: a refused launch raises).
Each launch adds one to the wrapper module's launch count (:func:`count`:
exact when the shares of a sharded MC launch from threads of their own).
"""

from __future__ import annotations

import ctypes
import threading

import torch

# guards every launch count of kernels/ (a dict's += is a read, an add and
# a write, which two threads can interleave)
_COUNT_LOCK = threading.Lock()


def dtype_suffix(dtype: torch.dtype) -> str:
    """``f64`` / ``f32``: the suffix of a kernel's exported symbol."""
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"the kernels take float32 or float64, got {dtype}")


def is_cpu(t: torch.Tensor | torch.device) -> bool:
    """True for a CPU tensor or device, False for CUDA; raises on others."""
    dev = t if isinstance(t, torch.device) else t.device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or CPU tensors, got {dev}")
    return False


def count(counts: dict, name: str, n: int = 1) -> None:
    """``counts[name] += n``, exact under concurrent callers."""
    with _COUNT_LOCK:
        counts[name] += n


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch(counts: dict, kernel: str, symbol: str, device: torch.device,
           *args) -> None:
    """Call ``symbol`` of the kernel library on ``device``'s current
    stream, raise on a refused launch, and count it under
    ``counts[kernel]``."""
    from divergence_tpu_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, symbol)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.fet_cuda_error_string(rc).decode()
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc} ({msg})")
    count(counts, kernel)


def query_form(names: tuple[str, ...], symbol: str, device: torch.device | None,
               *args) -> tuple[str, int]:
    """The form a large-panel or wide-window kernel takes for ``args`` on
    ``device`` (the current device for None), as the kernel library's
    ``symbol`` query reckons it from the kernels' own slab layouts and the
    device's shared memory: (``names[form]``, the elements or bytes of its
    device slab or scratch).  Builds the library on first use."""
    from divergence_tpu_torch.kernels import _build

    lib = _build.library()
    elems = ctypes.c_int64(0)
    with torch.cuda.device(device):
        rc = getattr(lib, symbol)(*args, ctypes.byref(elems))
    if rc < 0:
        raise RuntimeError(f"{symbol}{args} found no form on the device (code {rc}: -1, "
                           f"the device could not be asked; else too large for its "
                           f"shared memory)")
    return names[rc], elems.value
