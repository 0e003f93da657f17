"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds): one ``nvcc -c`` per source, all started together, then
one link.  The library lands in ``divergence_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the last build.  Nothing here runs at import:
:func:`library` builds on first use.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` — the plain
torch versions run multiplies and adds as separate rounded operations,
and a contracted ``a*b + c`` would move the kernels' results by an ulp
(enough to flip a bootstrap rank at a ``ceil`` boundary).  ``-Xptxas -v``
writes each kernel's registers, spills and shared memory to the build
log.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")   # when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_D = ctypes.c_double
_F = ctypes.c_float
_PI64 = ctypes.POINTER(ctypes.c_int64)
# symbol -> argtypes (every pointer and the trailing stream as c_void_p);
# a {t} symbol exists once per dtype, f64 and f32
_SIGNATURES = {
    # lf, nmax, asize, bsize, maxs, out, stream
    "fet_lut_build_{t}": (_P, _I, _I, _I, _I, _P, _P),
    # vals, n, asize, bsize, lut (nullable), lf, nmax, maxs, out, stream
    "fet_snp_logs_{t}": (_P, _I64, _I, _I, _P, _P, _I, _I, _P, _P),
    # logs, rows[3, B], B, key0, key1, perc, nsamples, pmax, out, stream
    "fet_aggregate_{t}": (_P, _P, _I64, _U32, _U32, _D, _I, _I, _P, _P),
    # ... fet_aggregate's arguments to pmax, then gscratch, out, stream
    "fet_aggregate_wide_{t}": (_P, _P, _I64, _U32, _U32, _D, _I, _I, _P, _P, _P),
    # lut, G, span, scratch keys / index x 2 (nullable), lut_sorted,
    # rank_of_entry, stream
    "fet_lut_rank_{t}": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # vals, n, asize, bsize, rank_of_entry, out, stream
    "fet_snp_ranks": (_P, _I64, _I, _I, _P, _P, _P),
    # lut_sorted, G, ranks, rows[3, B], B, key0, key1, perc, nsamples, pmax,
    # out, stream
    "fet_aggregate_ranks_{t}": (_P, _I, _P, _P, _I64, _U32, _U32, _D, _I, _I, _P,
                                _P),
    # ... fet_aggregate_ranks's arguments to pmax, then gscratch, out, stream
    "fet_aggregate_ranks_wide_{t}": (_P, _I, _P, _P, _I64, _U32, _U32, _D, _I, _I, _P,
                                     _P, _P),
    # av, bv, npos, slots, B, p_in, asize, bsize, lut (nullable), lf, nmax,
    # maxs, key0, key1, perc, nsamples, pmax, out, stream
    "fet_window_{t}": (_P, _P, _P, _P, _I64, _I, _I, _I, _P, _P, _I, _I, _U32,
                       _U32, _D, _I, _I, _P, _P),
    # ... fet_window's arguments to pmax, then gscratch, out, stream
    "fet_window_wide_{t}": (_P, _P, _P, _P, _I64, _I, _I, _I, _P, _P, _I, _I, _U32,
                            _U32, _D, _I, _I, _P, _P, _P),
    # vals, N, lo, npos, B, m, planes scratch [2, ceil(N/32) + 1, m], out,
    # stream
    "css_dissim_{t}": (_P, _I64, _P, _P, _I64, _I, _P, _P, _P),
    # av, bv, npos, B, p_in, asize, bsize, out, stream
    "css_dissim_gathered_{t}": (_P, _P, _P, _I64, _I, _I, _I, _P, _P),
    # vals, N, lo, npos, B, m, planes scratch, out, stream (the tile form)
    "css_dissim_tiles_{t}": (_P, _I64, _P, _P, _I64, _I, _P, _P, _P),
    # av, bv, npos, lo (first bits), B, p_in, asize, bsize, planes scratch
    # [2, B, ceil(p_in/32) + 1, m], out, stream
    "css_dissim_gathered_tiles_{t}": (_P, _P, _P, _P, _I64, _I, _I, _I, _P, _P, _P),
    # dis, npos, B, asize, bsize, wa, wb, scores, dist, valid, steps
    # (nullable), stream
    "css_cmds_{t}": (_P, _P, _I64, _I, _I, _D, _D, _P, _P, _P, _P, _P),
    # ... css_cmds's arguments, then gslab (nullable), nslab, stream
    "css_cmds_block_{t}": (_P, _P, _I64, _I, _I, _D, _D, _P, _P, _P, _P, _P, _I64, _P),
    # dis, npos, slots, B, key0, key1, asize, bsize, mode, n_init,
    # max_iters, eps, wa, wb, scores, dist, valid, restart, ntrans, total
    # (nullable), counters, sig / x / n scratch, stream
    "css_smacof_{t}": (_P, _P, _P, _I64, _U32, _U32, _I, _I, _I, _I, _I, _D,
                       _D, _D, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # ... css_smacof's arguments to total, then the task counter, gslab
    # (nullable), nslab, stream
    "css_smacof_block_{t}": (_P, _P, _P, _I64, _U32, _U32, _I, _I, _I, _I, _I, _D,
                             _D, _D, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    # key0, key1, k0, nk, chunk, cstride, m, asize, bitgen, between, ca, cb,
    # out, stream
    "css_mc_coeff": (_U32, _U32, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P),
    # ... css_mc_coeff's arguments to cb, then gscratch (nullable), out,
    # stream
    "css_mc_coeff_block": (_U32, _U32, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P),
    # dist, m, active, nact, obs, M, k0, nk, chunk, cstride, runs, words,
    # stream
    "css_mc_shared": (_P, _I, _P, _I64, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    # words, active, nact, k0, nk, chunk, cstride, runs, threshold, hits,
    # nsc, done, stream
    "css_mc_scan": (_P, _P, _I64, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # dist, obs, wkeys, active, nact, m, asize, k0, nk, chunk, cstride, runs,
    # bitgen, f64, between, ca, cb, wa, wb, inv_ab, words, stream
    "css_mc_window": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _F, _D, _D, _D, _P, _P),
    # ... css_mc_window's arguments to inv_ab, then gscratch (nullable),
    # words, stream
    "css_mc_window_block": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _F, _F, _F, _D, _D, _D, _P, _P, _P),
    # dist, obs, need, keys, B, m, asize, chunk, limit, bitgen, between,
    # ca, cb, hits, reached, pos, stream
    "css_perm_chunk": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _F, _F, _F,
                       _P, _P, _P, _P),
    # ... css_perm_chunk's arguments to cb, then gscratch (nullable), hits,
    # reached, pos, stream
    "css_perm_chunk_block": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _F, _F, _F,
                             _P, _P, _P, _P, _P),
    # dist, B, m, M, nk, chunk, cstride, partial, out, stream
    "css_mc_power_shared": (_P, _I64, _I, _P, _I, _I, _I, _P, _P, _P),
    # dist, wkeys, B, m, asize, k0, nk, chunk, bitgen, between, ca, cb, out,
    # stream
    "css_mc_power_window": (_P, _P, _I64, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                            _P, _P),
    # ... css_mc_power_window's arguments to cb, then gscratch (nullable),
    # out, stream
    "css_mc_power_window_block": (_P, _P, _I64, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                  _P, _P, _P),
}
# the large-panel and wide-window kernels' form queries (no stream): the
# form a wrapper launches for these arguments on the current device, and
# the device slab's or scratch's elements (or bytes)
_FORM_QUERIES = {
    "css_dissim_form": (_I, _PI64),                       # m, 0
    "css_dissim_gathered_form": (_I, _I, _PI64),          # asize, bsize, 0
    "css_cmds_form_{t}": (_I, _PI64),                     # m, slab elems
    "css_smacof_form_{t}": (_I, _I, _PI64),               # m, mode, slab elems
    "css_mc_coeff_form": (_I, _I64, _PI64),               # m, ncols, scratch words
    "css_mc_window_form": (_I, _I, _PI64),                # m, float64, scratch bytes
    # pmax, nsamples, key bytes, value bytes, scratch bytes
    "fet_window_form": (_I, _I, _I, _I, _PI64),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path       # the shared library
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc / ptxas output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of divergence_tpu_torch/csrc cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` unless a library of the same sources and
    flags is already in ``_build/``."""
    BUILD_DIR.mkdir(exist_ok=True)
    lib = BUILD_DIR / f"libdivergence_kernels_{_digest()}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log)
    # unique temporary names, then an atomic rename: concurrent builds
    # never load a half-written library
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    procs = [
        (src, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, obj in zip(_sources(), objs)
    ]
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
             *map(str, objs)],
            capture_output=True, text=True, check=False,
        )
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    ``argtypes`` and ``restype`` declared."""
    lib = ctypes.CDLL(str(build().path))
    for pattern, argtypes in {**_SIGNATURES, **_FORM_QUERIES}.items():
        for t in ("f64", "f32") if "{t}" in pattern else ("",):
            fn = getattr(lib, pattern.format(t=t))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.fet_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.fet_cuda_error_string.restype = ctypes.c_char_p
    return lib
