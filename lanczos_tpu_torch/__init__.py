"""lanczos_tpu_torch — the PyTorch/CUDA port of `lanczos_tpu`.

Single- and block-Lanczos on one NVIDIA H100: plain tensor code in
PyTorch, and every kernel that `lanczos_tpu/ops/pallas/` writes in Pallas
for the TPU as a kernel written by hand in CUDA C++ for Hopper
(`csrc/`, wrapped in `ops/kernels/`).  The module paths mirror the JAX
package's, which stays in the repository as the reference.  This package
never imports jax.

Ported: the Maxwell folded-plane, flat-state and assembled-ELL operators,
`MatrixOperator`, the sparse containers (ELL/COO/CSR/BSR/DIA), the
windowed-ELL operator of assembled matrices (its SpMM is the CUDA kernel
K8), matrix IO, block Lanczos (materialized with full/periodic/selective
re-orthogonalization, TSQR normalization and adaptive restart; fused, with
compensated Grams), single-vector Lanczos, the eigsh drivers, the small
eigensolvers, both expm actions, the FDTD oracle, checkpoint/resume of
long Lanczos and FDTD runs, the generic separable stencil (K6) and the
CLI (`python -m lanczos_tpu_torch [--vector] [--operator pallas|ell]
[--profile DIR] ...`), the timing layer (`utils/`), the headline bench
(`python -m lanczos_tpu_torch.bench`), the benchmark drivers
(`benchmarks/`), the examples (`examples/`) and the C++ host engine
(`native/`), and the z-slab half of the multi-device layer
(`parallel/`: `make_mesh`, `DistributedPallasMaxwell`, `tsqr_sharded`,
one process a device on `torch.distributed`).  Not ported yet: the
row-sharded assembled-matrix operators.
Builders put their buffers on "cuda" unless given another device.

The names below load lazily, as in the JAX package: `from
lanczos_tpu_torch import block_lanczos_eigsh`.
"""

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)

__version__ = "0.1.0"

# the JAX package's `_API` names that are ported, and where they live
_API = {
    "vector_lanczos": "lanczos_tpu_torch.methods.vector_lanczos",
    "block_lanczos": "lanczos_tpu_torch.methods.block_lanczos",
    "lanczos_eigsh": "lanczos_tpu_torch.methods.eigs",
    "block_lanczos_eigsh": "lanczos_tpu_torch.methods.eigs",
    "lanczos_expm_action": "lanczos_tpu_torch.methods.expm_action",
    "block_lanczos_expm_action": "lanczos_tpu_torch.methods.expm_action",
    "fdtd_vector": "lanczos_tpu_torch.methods.fdtd",
    "fdtd_block": "lanczos_tpu_torch.methods.fdtd",
    "vector_lanczos_checkpointed": "lanczos_tpu_torch.methods.checkpoint",
    "block_lanczos_checkpointed": "lanczos_tpu_torch.methods.checkpoint",
    "fdtd_checkpointed": "lanczos_tpu_torch.methods.checkpoint",
    "EllMatrix": "lanczos_tpu_torch.ops.formats",
    "CsrMatrix": "lanczos_tpu_torch.ops.formats",
    "CooMatrix": "lanczos_tpu_torch.ops.formats",
    "BsrMatrix": "lanczos_tpu_torch.ops.formats",
    "DiaMatrix": "lanczos_tpu_torch.ops.formats",
    "ell_from_scipy": "lanczos_tpu_torch.ops.formats",
    "csr_from_scipy": "lanczos_tpu_torch.ops.formats",
    "coo_from_scipy": "lanczos_tpu_torch.ops.formats",
    "bsr_from_scipy": "lanczos_tpu_torch.ops.formats",
    "dia_from_scipy": "lanczos_tpu_torch.ops.formats",
    "WindowedEllMatrix": "lanczos_tpu_torch.ops.window_ell",
    "windowed_from_scipy": "lanczos_tpu_torch.ops.window_ell",
    "windowed_from_ell": "lanczos_tpu_torch.ops.window_ell",
    "PaddedWindowedOperator": "lanczos_tpu_torch.ops.window_ell",
    "tsqr": "lanczos_tpu_torch.ops.tsqr",
    "tsqr_sharded": "lanczos_tpu_torch.ops.tsqr",
    "LinearOperator": "lanczos_tpu_torch.ops.operator",
    "MaxwellOperator": "lanczos_tpu_torch.models.maxwell",
    "PallasMaxwellOperator": "lanczos_tpu_torch.models.maxwell_pallas",
    "DistributedPallasMaxwell": "lanczos_tpu_torch.parallel",
    "make_mesh": "lanczos_tpu_torch.parallel",
    "StencilSpec": "lanczos_tpu_torch.ops.kernels",
    "apply_stencil": "lanczos_tpu_torch.ops.kernels",
    "apply_stencil_pair": "lanczos_tpu_torch.ops.kernels",
    "LanczosConfig": "lanczos_tpu_torch.config",
    "load_sparse": "lanczos_tpu_torch.io",
    "operator_from_file": "lanczos_tpu_torch.io",
}

__all__ = ["__version__", *_API]


def __getattr__(name):
    if name in _API:
        import importlib

        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(f"module 'lanczos_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
