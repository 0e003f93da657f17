"""Native C++ host runtime of the port, loaded with ctypes: the threaded
GTrack parser (``gtrack_parser.cpp``) and VCF converter
(``vcf_convert.cpp``), byte-for-byte copies of the JAX package's
``divergence_tpu/native`` sources.  The JAX package's permutation-MC
evaluator (``mc_native.cpp``) is not carried: ``perm_backend="native"``
runs K8's float64 form on the card.

``g++`` compiles the two sources into one shared library on first use
(nothing builds at import), with ``-march=native``: the library lands in
``divergence_tpu_torch/_build/`` under a name keyed by a digest of the
sources and flags and by the host's ISA (:func:`_host_cpu_tag`), written
under a per-process, per-thread temporary name and renamed into place,
so concurrent builds never load a half-written file.  Toolchains that
reject the tuning flags get a build without them.

Every entry point returns None where the library is unavailable, and the
callers fall back to the pure-Python readers, which define the semantics
(``io/gtrack.py``, ``io/vcf.py``).  ``DIVERGENCE_TPU_NO_NATIVE`` (any
non-empty value) turns the library off, as in the JAX package.  A failed
build prints the compiler's message once to stderr; :func:`build_error`
returns it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "gtrack_parser.cpp"
_SRC_VCF = _HERE / "vcf_convert.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX = ("g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# the tuned flags, then none: some toolchains reject -march=native
CXX_TUNINGS = (("-march=native", "-funroll-loops"), ())


def _host_cpu_tag() -> str:
    """Short tag identifying this host's ISA extensions.

    The library is compiled with -march=native, so a .so cached in the
    package directory must not be served to a host with a different CPU
    (shared NFS installs across a heterogeneous fleet would SIGILL).
    Keyed on the kernel-reported feature flags; falls back to the bare
    machine arch when /proc/cpuinfo is unavailable (macOS et al.)."""
    import hashlib
    import platform

    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    ident += " " + " ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        pass
    return hashlib.sha1(ident.encode()).hexdigest()[:10]


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None
_build_failed = False
_build_error: str | None = None


class _GtrackResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("vals", ctypes.POINTER(ctypes.c_double)),
        ("seq_idx", ctypes.POINTER(ctypes.c_int32)),
        ("n_seqids", ctypes.c_int32),
        # POINTER(c_char), not c_char_p: the blob contains interior NULs
        # and c_char_p would truncate at the first one
        ("seqid_blob", ctypes.POINTER(ctypes.c_char)),
        ("blob_len", ctypes.c_int64),
    ]


def library_name(tuning: tuple[str, ...]) -> str:
    """The library's file name for one set of tuning flags: a digest of
    the compiler line and both sources, and the host's ISA tag."""
    h = hashlib.sha256(" ".join(CXX + tuning).encode())
    for src in (_SRC, _SRC_VCF):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return f"libdivergence_host_{h.hexdigest()[:16]}_{_host_cpu_tag()}.so"


def _compile(tuning: tuple[str, ...], build_dir: Path) -> tuple[Path | None, str]:
    """(library, "") once ``build_dir`` holds the library built with
    ``tuning`` (built now unless an earlier build left it), else (None,
    the compiler's message).  The compiler writes a name of this process
    and thread only; ``os.replace`` then puts the whole file in place."""
    lib = build_dir / library_name(tuning)
    if lib.exists():
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    try:
        proc = subprocess.run(
            [*CXX, *tuning, str(_SRC), str(_SRC_VCF), "-o", str(tmp)],
            capture_output=True, text=True, timeout=300, check=False,
        )
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        return None, f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None, (proc.stderr or proc.stdout or f"exit {proc.returncode}").strip()
    os.replace(tmp, lib)
    return lib, ""


def _build(build_dir: Path = BUILD_DIR) -> Path | None:
    """The library for these sources on this host, built if need be with
    the tuned flags, then without them; None (the first message kept in
    :func:`build_error`, and printed once) when neither builds."""
    global _build_error
    errors = []
    for tuning in CXX_TUNINGS:
        lib, err = _compile(tuning, build_dir)
        if lib is not None:
            return lib
        errors.append(f"[{' '.join(CXX + tuning)}] {err}")
    _build_error = "\n".join(errors)
    print(f"divergence_tpu_torch.native: the host library did not build, the Python "
          f"readers run instead:\n{_build_error}", file=sys.stderr)
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_path, _build_failed, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if os.environ.get("DIVERGENCE_TPU_NO_NATIVE"):
            _build_failed = True
            return None
        path = _build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_failed = True
            _build_error = f"{path.name} did not load: {e}"
            print(f"divergence_tpu_torch.native: {_build_error}", file=sys.stderr)
            return None
        lib.gtrack_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(_GtrackResult),
            ctypes.c_int,
        ]
        lib.gtrack_parse.restype = ctypes.c_int
        lib.gtrack_free.argtypes = [ctypes.POINTER(_GtrackResult)]
        lib.gtrack_free.restype = None
        lib.vcf_convert.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_longlong,
            ctypes.c_int,
        ]
        lib.vcf_convert.restype = ctypes.c_longlong
        _lib, _lib_path = lib, path
        return lib


def library_path() -> Path | None:
    """The loaded library's path (building it if need be), or None."""
    return _lib_path if _load() is not None else None


def build_error() -> str | None:
    """Why the library is unavailable: the compiler's or loader's message,
    ``"DIVERGENCE_TPU_NO_NATIVE is set"``, or None where it loaded."""
    if _load() is not None:
        return None
    if _build_error is None and os.environ.get("DIVERGENCE_TPU_NO_NATIVE"):
        return "DIVERGENCE_TPU_NO_NATIVE is set"
    return _build_error


def parse_gtrack_native_indexed(
    path: str | Path, n_threads: int = 0
) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray] | None:
    """Parse a GTrack valued-points file with the C++ parser.

    Returns (seqid_names, seq_idx int32 [n_rows], pos int64, vals float64)
    in file row order, with seqids interned as indices into
    ``seqid_names`` — integer grouping downstream is ~10x faster than
    object-array comparisons.  None when native parsing is unavailable."""
    lib = _load()
    if lib is None:
        return None
    res = _GtrackResult()
    rc = lib.gtrack_parse(
        str(path).encode(), ctypes.byref(res), int(n_threads)
    )
    if rc != 0:
        return None
    try:
        n = res.n_rows
        pos = np.ctypeslib.as_array(res.pos, shape=(n,)).copy() if n else (
            np.zeros(0, dtype=np.int64)
        )
        vals = np.ctypeslib.as_array(res.vals, shape=(n,)).copy() if n else (
            np.zeros(0, dtype=np.float64)
        )
        seq_idx = (
            np.ctypeslib.as_array(res.seq_idx, shape=(n,)).copy()
            if n
            else np.zeros(0, dtype=np.int32)
        )
        blob = ctypes.string_at(res.seqid_blob, res.blob_len)
        names = [x.decode() for x in blob.split(b"\x00")[: res.n_seqids]]
        return names, seq_idx, pos, vals
    finally:
        lib.gtrack_free(ctypes.byref(res))


def parse_gtrack_native(
    path: str | Path, n_threads: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Like :func:`parse_gtrack_native_indexed` but materializes seqids as
    an object array of names (the Python reader's pre-grouping contract)."""
    parsed = parse_gtrack_native_indexed(path, n_threads)
    if parsed is None:
        return None
    names, seq_idx, pos, vals = parsed
    arr = np.asarray(names, dtype=object)
    seq = arr[seq_idx] if len(seq_idx) else np.zeros(0, dtype=object)
    return seq, pos, vals


def vcf_convert_native(
    vcf_path: str | Path,
    out_path: str | Path,
    gtrack_header: str,
    population: list[str],
    n_threads: int = 0,
) -> list[str] | None:
    """Threaded C++ VCF -> GTrack conversion (vcf_convert.cpp).

    Returns the population names found in the header, or None when the
    native path is unavailable or the conversion failed (callers fall
    back to the pure-Python converter, which defines the semantics)."""
    lib = _load()
    if lib is None:
        return None
    # '\n'-separated marshalling: newline cannot appear inside a VCF
    # header column (columns are single-line, tab-separated), unlike ','
    # which is legal in a sample ID; buffer sized in UTF-8 BYTES
    names_blob = "\n".join(population).encode()
    found = ctypes.create_string_buffer(len(names_blob) + 16)
    rows = lib.vcf_convert(
        str(vcf_path).encode(),
        str(out_path).encode(),
        gtrack_header.encode(),
        names_blob,
        found,
        ctypes.c_longlong(len(found)),
        int(n_threads),
    )
    if rows < 0:
        return None
    text = found.value.decode()
    return [n for n in text.split("\n") if n]


def native_available() -> bool:
    return _load() is not None
