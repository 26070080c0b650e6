"""Build, load and count the hand-written CUDA kernels.

The kernels live in one CUDA C++ file, `lanczos_tpu_torch/csrc/
lanczos_kernels.cu`, with a plain C interface.  At first use on a CUDA
tensor, `library()` compiles it with nvcc for Hopper (sm_90a) into
`lanczos_tpu_torch/_build/` and loads it with ctypes; the file name carries
a hash of the source and flags, so an edit rebuilds and an unchanged tree
reuses the library.  A failed build raises.  Nothing here runs at import:
CPU-only installs import every module and never build.

Every launch goes through `launch`: it enters the tensor's device, calls
the C entry point, adds to `LAUNCHES` (kernel launches by wrapper name,
and apart from them, under "<name> bf16", those on bf16 states) and to
the host-launch counter (`utils/tracing.py`'s "launches.host"), and
raises on the entry point's error.  So a launch runs on the card that
holds its tensors, as JAX places work by the array's device, and a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from lanczos_tpu_torch.utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE = PACKAGE_DIR / "csrc" / "lanczos_kernels.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / spills into the build log
)

LAUNCHES = {
    "apply_stencil_pair": 0,
    "block_mix": 0,
    "block_grams": 0,
    "apply_stencil_pair_gram": 0,
    "fdtd_step": 0,
    "block_grams_compensated": 0,
    "windowed_spmm": 0,
    "apply_stencil": 0,
    "jacobi_sqrtm": 0,
    "tsqr": 0,
    "cgs2": 0,
    # the kernels that take bf16 states, counted apart on them
    "apply_stencil_pair bf16": 0,
    "block_mix bf16": 0,
    "block_grams bf16": 0,
    "block_grams_compensated bf16": 0,
    "jacobi_sqrtm bf16": 0,
}

# the .cu's dtype codes; 2 is a bf16 state with f32 weights, coefficients
# and sums, which K1, K2, K3 and K7 take, and S1 a bf16 matrix
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_LLP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "lt_stencil_pair": (_I, _P, _P, _P, _P, _IP, _IP, _I, _I, _I, _I, _P),
    "lt_block_mix": (_I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _LL, _I, _I, _I,
                     _P),
    "lt_block_grams": (
        _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _LL, _I, _I, _I, _P, _I,
        _P, _P, _P,
    ),
    "lt_stencil_pair_gram": (
        _I, _P, _P, _P, _P, _IP, _IP, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    "lt_fdtd_step": (_I, _P, _P, _P, _P, _IP, _IP, _I, _I, _I, _I, _P),
    "lt_block_grams_compensated": (
        _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _LL, _I, _I, _I, _P, _I,
        _P, _P, _P,
    ),
    "lt_windowed_spmm": (
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _P,
    ),
    "lt_gram_blocks_per_sm": (),
    "lt_mix_blocks_per_sm": (),
    "lt_stencil_blocks_per_sm": (_I, _I, _I, _LL),
    "lt_apply_stencil": (
        _I, _P, _P, _P, _P, _IP, _IP, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL,
        _P,
    ),
    "lt_sqrtm_invsqrtm": (_I, _P, _P, _P, _I, _I, _I, ctypes.c_double, _I, _I,
                          _P),
    "lt_tsqr": (_I, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _P),
    "lt_cgs2": (_I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _LL, _I, _I, _I,
                _I, _LL, _P),
}

_lib: ctypes.CDLL | None = None
build_log = ""
_sm_counts: dict[int, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "lanczos_tpu_torch are built from source at first use"
    )


def build(source: Path | None = None) -> Path:
    """Compile the kernel library from `source` (default SOURCE) if this
    source/flag combination has not been built yet; returns its path.  The
    nvcc log (with `-Xptxas -v`'s register and spill report) is kept in
    `build_log`.  Builds of different sources may run in threads at once."""
    global build_log
    source = SOURCE if source is None else source
    src = source.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"liblanczos_kernels-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, out)
    return out


def load(path: Path, signatures: dict | None = None) -> ctypes.CDLL:
    """The kernel library built at `path`, its entry points typed by
    `signatures` (default this source's, `_SIGNATURES`)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in (signatures or _SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def launch(name: str, t: torch.Tensor, entry: str, *args, count: int = 1) -> None:
    """Calls the C entry point `entry` with `args` on t's device (its
    launches go to that card's stream, which the caller passes in args),
    adds `count` kernel launches to LAUNCHES[name], or to LAUNCHES[name +
    " bf16"] when t is a bf16 state, and to "launches.host", and raises on
    the entry point's error."""
    with torch.cuda.device(t.device):
        err = getattr(library(), entry)(*args)
    LAUNCHES[name + " bf16" if t.dtype == torch.bfloat16 else name] += count
    tracing.count("launches.host", count)
    check(err, name)


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a kernel computes in for a state of `dtype`: its weights,
    coefficients and sums.  f32, or the state's own if wider: a bf16 state
    promotes to f32, as JAX promotes it to its f32 weights."""
    return torch.promote_types(torch.float32, dtype)


def dtype_code(t: torch.Tensor, bf16: bool = False) -> int:
    """t's dtype code for the .cu; bf16 states only where the kernel has
    them (`bf16=True`: K1, K2, K3, K7, S1)."""
    if t.dtype == torch.bfloat16 and not bf16:
        raise TypeError("this CUDA kernel takes float32 or float64 states, "
                        "not bfloat16")
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"CUDA kernels take float32, float64 or (K1, K2, K3, K7, S1) bfloat16 "
            f"states, got {t.dtype}"
        ) from None


def require_cuda(name: str, *tensors: torch.Tensor, bf16: bool = False) -> None:
    """The checks every launch shares: CUDA, one device, one dtype,
    contiguous; `bf16` as in `dtype_code`."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {dt} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    dtype_code(tensors[0], bf16)


def sm_count(device: torch.device) -> int:
    """The SMs of the card `device` names; read once a device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def gram_grid_cap(device: torch.device) -> int:
    """The most blocks of the Gram kernel's grid on `device`: the kernel's
    blocks per SM (kGramBlocksPerSM of the .cu) times the card's SMs, so
    the grid runs in whole waves (528 on an H100)."""
    return library().lt_gram_blocks_per_sm() * sm_count(device)


def mix_grid_cap(device: torch.device) -> int:
    """The most blocks of K2's grid on `device`: its blocks per SM
    (kMixBlocksPerSM of the .cu) times the card's SMs, so the grid runs in
    whole waves (264 on an H100)."""
    return library().lt_mix_blocks_per_sm() * sm_count(device)
