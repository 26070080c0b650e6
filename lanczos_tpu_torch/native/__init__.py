"""The port's C++ host engine: CSR -> ELL (whole, or row-sharded with
halo-window columns), the windowed-ELL planner and the Maxwell ELL
assembly (port of `lanczos_tpu/native`).

`lanczos_tpu_torch/csrc/lanczos_native.cpp` is built with g++ (`-O3
-pthread -shared -fPIC`; its loops run on POSIX threads, so no OpenMP
runtime is needed) at first use into `lanczos_tpu_torch/_build/` and
loaded with ctypes.  The library's name carries a hash of the source, the
flags, the compiler's version and the host's platform, so an edit rebuilds
and an unchanged tree reuses it.  Processes that build at once (test
workers) take a file lock; the one that builds writes to a private name
and renames it into place, so no process loads a half-written library.
A failed build raises with the compiler's output: there is no quiet NumPy
fallback (the NumPy versions are the plain references the tests hold this
engine to, reached by an explicit `packer="numpy"`).  Nothing builds at
import.

Every entry point is bit-equal to the NumPy path it replaces.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "lanczos_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-pthread", "-shared", "-fPIC")

_I64, _P = ctypes.c_int64, ctypes.c_void_p
_MAXWELL = (_I64, _I64, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _P, _P)
_SIGNATURES = {
    "ell_from_csr_f32": ((_I64, _I64, _I64, _P, _P, _P, _P, _P), None),
    "ell_from_csr_f64": ((_I64, _I64, _I64, _P, _P, _P, _P, _P), None),
    "halo_ell_from_csr_f32": ((_I64,) * 6 + (_P,) * 5, None),
    "halo_ell_from_csr_f64": ((_I64,) * 6 + (_P,) * 5, None),
    "maxwell_ell_f32": (_MAXWELL, ctypes.c_int),
    "maxwell_ell_f64": (_MAXWELL, ctypes.c_int),
    "window_pack_count": ((_I64, _P, _P), _I64),
    "window_pack_fill_f32": ((_I64, _I64, _P, _P, _P, _P, _P, _P), None),
    "window_pack_fill_f64": ((_I64, _I64, _P, _P, _P, _P, _P, _P), None),
}
_SUFFIX = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}

_lib: ctypes.CDLL | None = None
build_log = ""
build_seconds = 0.0  # of the build this process ran (0 if it reused one)


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found (set CXX): the C++ host engine of "
            "lanczos_tpu_torch is built from source at first use"
        )
    return cxx


def build() -> Path:
    """Compile the engine unless this source, flag and compiler combination
    is built already; returns the library's path."""
    global build_log, build_seconds
    cxx = _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    # the host's platform too: a copied tree must not load another host's build
    key = SOURCE.read_bytes() + " ".join(
        (cxx, version, platform.platform(), *CXX_FLAGS)).encode()
    out = BUILD_DIR / f"liblanczos_native-{hashlib.sha1(key).hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        # the kernel holds the lock for this process only: a process that
        # dies while building releases it, so no stale lock outlives a build
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}"
            )
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded engine, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _suffix(dtype) -> str:
    try:
        return _SUFFIX[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"the native engine takes float32 or float64, got "
                        f"{np.dtype(dtype)}") from None


def _csr(indptr, indices, n_rows: int):
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    if indptr.shape != (n_rows + 1,) or (
            n_rows and (indptr[0] != 0 or indptr[-1] > len(indices))):
        raise ValueError(f"indptr of shape {indptr.shape} does not describe "
                         f"{n_rows} rows over {len(indices)} entries")
    return indptr, indices


def ell_from_csr(indptr, indices, data, n_rows: int, width: int, dtype,
                 rows_pad: int | None = None):
    """(data (rows_pad, width) in dtype, idx int32) from CSR arrays; row k
    holds the row's first `width` entries in CSR order, then zeros (pad
    rows are zero).  The NumPy version is `formats.ell_from_scipy`'s
    `packer="numpy"` path."""
    suffix = _suffix(dtype)
    indptr, indices = _csr(indptr, indices, n_rows)
    vals = np.ascontiguousarray(data, np.float64)
    rows_pad = n_rows if rows_pad is None else rows_pad
    out = np.empty((rows_pad, width), np.dtype(dtype))
    idx = np.empty((rows_pad, width), np.int32)
    getattr(library(), f"ell_from_csr_{suffix}")(
        n_rows, rows_pad, width, _ptr(indptr), _ptr(indices), _ptr(vals),
        _ptr(out), _ptr(idx))
    return out, idx


def halo_ell_from_csr(indptr, indices, data, n_rows: int, width: int,
                      rows_loc: int, halo: int, dtype, row0: int = 0,
                      rows_out: int | None = None):
    """(data (rows_out, width) in dtype, idx int32): rows [row0, row0 +
    rows_out) of the row-sharded halo ELL (default: all n_rows).  Row i's
    columns become positions in its shard's window, c - base + halo with
    base = (i // rows_loc) rows_loc; pad entries are data 0 at `halo`, and
    rows at or past n_rows are all pad.  The NumPy version is
    `parallel.dist_operator.halo_shard`'s `packer="numpy"` path."""
    suffix = _suffix(dtype)
    indptr, indices = _csr(indptr, indices, n_rows)
    vals = np.ascontiguousarray(data, np.float64)
    rows_out = n_rows - row0 if rows_out is None else rows_out
    if row0 < 0 or rows_out < 0 or rows_loc < 1 or halo < 0:
        raise ValueError(f"halo_ell_from_csr: row0={row0}, rows_out={rows_out}, "
                         f"rows_loc={rows_loc}, halo={halo}")
    out = np.empty((rows_out, width), np.dtype(dtype))
    idx = np.empty((rows_out, width), np.int32)
    getattr(library(), f"halo_ell_from_csr_{suffix}")(
        n_rows, row0, rows_out, width, rows_loc, halo, _ptr(indptr),
        _ptr(indices), _ptr(vals), _ptr(out), _ptr(idx))
    return out, idx


def window_pack_count(indptr, indices, n_rows: int) -> int:
    """Pass 1 of the windowed-ELL planner: planes per chunk (at least 1),
    so that the caller checks its cap before the planes are allocated."""
    indptr, indices = _csr(indptr, indices, n_rows)
    return max(int(library().window_pack_count(n_rows, _ptr(indptr),
                                               _ptr(indices))), 1)


def window_pack_fill(indptr, indices, data, n_rows: int, ppc: int):
    """Pass 2: (planes_data (C, ppc, 128) in data's dtype, planes_lidx
    int32 in [0, 256), planes_fabs (C, ppc) int64, -1 for empty planes),
    with ppc from `window_pack_count`."""
    data = np.ascontiguousarray(data)
    suffix = _suffix(data.dtype)
    indptr, indices = _csr(indptr, indices, n_rows)
    n_chunks = -(-n_rows // 128)
    dat = np.empty((n_chunks, ppc, 128), data.dtype)
    lidx = np.empty((n_chunks, ppc, 128), np.int32)
    fabs = np.empty((n_chunks, ppc), np.int64)
    getattr(library(), f"window_pack_fill_{suffix}")(
        n_rows, ppc, _ptr(indptr), _ptr(indices), _ptr(data), _ptr(dat),
        _ptr(lidx), _ptr(fabs))
    return dat, lidx, fabs


def maxwell_ell(descs, arrays, comp_shapes, dtype, width: int = 4):
    """The Maxwell operator A = D diag(w) as ELL (data (n, width) in dtype,
    idx int32) from its tap table (`models.maxwell._build_taps`: descs
    (out_comp, in_comp, axis, offset), arrays (wz, wy, wx) over the output
    component's extents).  Each row holds its entries in ascending column
    order, then zeros: the layout `ell_from_scipy(assemble_maxwell_A(...))`
    gives; the values are the f64 products of the tap weights rounded once
    to dtype."""
    suffix = _suffix(dtype)
    meta = np.ascontiguousarray(descs, np.int64).reshape(-1)
    w = [np.ascontiguousarray(np.concatenate([np.asarray(t[a], np.float64)
                                              for t in arrays]))
         for a in range(3)]
    offs = [np.ascontiguousarray(np.cumsum([0] + [len(t[a]) for t in arrays[:-1]]),
                                 np.int64) for a in range(3)]
    shapes = np.ascontiguousarray(comp_shapes, np.int64).reshape(-1)
    sizes = [int(np.prod(s)) for s in comp_shapes]
    comp_off = np.ascontiguousarray(np.cumsum([0] + sizes[:-1]), np.int64)
    n = sum(sizes)
    out = np.empty((n, width), np.dtype(dtype))
    idx = np.empty((n, width), np.int32)
    err = getattr(library(), f"maxwell_ell_{suffix}")(
        n, n, width, len(descs), len(comp_shapes), _ptr(meta),
        _ptr(w[0]), _ptr(offs[0]), _ptr(w[1]), _ptr(offs[1]), _ptr(w[2]),
        _ptr(offs[2]), _ptr(shapes), _ptr(comp_off), _ptr(out), _ptr(idx))
    if err:
        raise ValueError(
            f"maxwell_ell: a row holds more than {width} entries" if err == 1
            else "maxwell_ell: a component has more than 16 taps")
    return out, idx
