"""Least traffic of one `expm` request: m-step block Lanczos with the
symmetric normalization (no re-orthogonalization), then the small expm.

What the recurrence's data dependencies force, on the logical state of n
unknowns a column (the algorithm's vector, not any storage layout):
- start: read B (its Gram, before Q_0 = B beta_0^-1 can exist) and write
  Q_0;
- each of the m iterations: read Q_j (the product A Q_j and the Grams
  fuse into that pass) and Q_{j-1}, write the next residual block.
So (2 + 3m) state blocks of n * p * itemsize bytes; A is a stencil of
constant coefficients and reads nothing else.  The receiver traces and
the (mp x mp) algebra are noise.  Operations: each product is 4 taps an
unknown (4 multiplies, 3 adds); each iteration makes two Grams and three
block mixes of 2 p^2 operations an unknown; start one Gram and one mix.
"""

from __future__ import annotations

from portbench.inputs import maxwell_unknowns

ITEMSIZE = {"float32": 4, "float64": 8}
STENCIL_FLOPS = 7  # a product's operations an unknown and column


def request(cfg: dict, tr: dict) -> dict:
    n, p, m = maxwell_unknowns(int(cfg["n_grid"])), int(tr["p"]), int(tr["m"])
    block = n * p * ITEMSIZE[cfg["dtype"]]
    return {
        "bytes": (2 + 3 * m) * block,
        "flops": m * STENCIL_FLOPS * n * p + (2 + 5 * m) * 2 * p * p * n,
    }
