"""lanczos_tpu_torch — the PyTorch/CUDA port of `lanczos_tpu`.

Single- and block-Lanczos on one NVIDIA H100: plain tensor code in
PyTorch, and every kernel that `lanczos_tpu/ops/pallas/` writes in Pallas
for the TPU as a kernel written by hand in CUDA C++ for Hopper
(`csrc/`, wrapped in `ops/kernels/`).  The module paths mirror the JAX
package's, which stays in the repository as the reference.  This package
never imports jax.

Ported so far: the Maxwell folded-plane and flat-state operators,
`MatrixOperator`, bare block Lanczos (materialized and fused, with
compensated Grams), single-vector Lanczos (reorth none/full/selective),
the small eigensolvers, both expm actions, the FDTD oracle and the CLI
(`python -m lanczos_tpu_torch [--vector] [--operator pallas] ...`).
"""

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)

__version__ = "0.1.0"
