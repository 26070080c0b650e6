"""Hand-written Hopper kernels (CUDA C++, `lanczos_tpu_torch/csrc/`), the
counterparts of the Pallas kernels in `lanczos_tpu/ops/pallas/`.

Each wrapper launches its kernel on a CUDA tensor and runs its plain torch
version on a CPU tensor; `build.LAUNCHES` counts the launches.
"""

from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    StencilSpec,
    apply_stencil,
    apply_stencil_pair,
)

__all__ = ["StencilSpec", "apply_stencil", "apply_stencil_pair"]
