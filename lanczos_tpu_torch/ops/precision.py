"""Matmul precision policy: full f32 in every contraction.

The torch counterpart of `lanczos_tpu/ops/precision.py`'s ``HIGHEST``.  A
Lanczos library cannot round its Gram products or basis recombinations
through a short mantissa: basis orthogonality degrades to that level, T
drifts off V^T A V, and Ritz values acquire errors with tiny claimed
residual bounds (README "Numerical robustness").  On the H100 the danger
is TF32, which keeps about three decimal digits: cuBLAS uses it for f32
matmuls when ``torch.backends.cuda.matmul.allow_tf32`` is set, and cuDNN
by default.  Importing this module turns both off and checks that no one
has lowered ``torch.get_float32_matmul_precision()``; every port module
that contracts imports it.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert torch.get_float32_matmul_precision() == "highest", (
    "lanczos_tpu_torch needs full-f32 matmuls; something set "
    f"float32_matmul_precision={torch.get_float32_matmul_precision()!r}"
)
