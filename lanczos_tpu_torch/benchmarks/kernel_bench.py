"""Per-kernel micro-benchmarks (port of `benchmarks/kernel_bench.py`, the
counterpart of the reference's `source/kernels/measurements/*.cu`).

    python -m lanczos_tpu_torch.benchmarks.kernel_bench [--only a,b] [--json PATH]

Campaigns (`BENCHES`), each on the port's counterpart of the JAX one:
  mm_tt, mm_tt2, mm_ts   Gram / tall x small products: `torch.mm` (the JAX
                         package computes these in XLA, not in Pallas)
  sqrtm                  sqrtm + inverse sqrtm of a p x p SPD matrix, per
                         small-eig backend (jacobi: S1, beside its plain
                         version; newton; lax: torch.linalg.eigh)
  spmm_ell               gathered ELL SpMM on the Maxwell matrix, plain torch
                         as XLA is, assembled by the native engine (so
                         --grid-ell 160, the reference's 24.6M rows, builds)
  spmm_dia, spmm_bsr     DIA and BSR (windowed engine = K8, einsum engine)
  spmm_stencil           the Maxwell stencil SpMM: K1
  spmm_stencil_bf16      the same on the bf16 operator's state (f32 weights
                         and sums): K1's bf16 instantiation
  spmm_windowed          the windowed-ELL SpMM: K8
  copy_bw                y <- 1 - y, one read and one write of the state
  block_mix              K2, into a fresh buffer and in place
  block_grams            K3
  block_grams_compensated K7, at p <= 8 as the JAX campaign
  fused_iter             one fused block-Lanczos iteration on Maxwell N=160:
                         the two-call mono step (K2 + K4) against the 3-call
                         step (K2 + K1 + K3)
  dtype_f64              block Lanczos per iteration, f32 against f64

Widths: the reference's N_COL = 2..18 (`NCOLS`) where the JAX campaign
sweeps them.  Every kernel here takes every width of its campaign but two:
K7 runs p <= 8 (the JAX campaign's widths) and the mono step (K4) exists
for p <= 8 (its CUDA instantiations, `stencil_gram.MAX_P`), so fused_iter's
mono column is NaN at p = 16 and its route says so.

Timing: `utils.bench_loop` (the slope of two chain lengths, CUDA events on
the card).  A chained self-map folds its anti-overflow scale into the
operator (1 / an estimate of ||A||), so no extra pass is timed.  Byte and
flop models are the JAX campaigns'; mm_tt's counts T twice, as the
reference's formula does (`measurements/mm_tt.cu:249-256`).

Roofline guard (on the card): no physical GB/s column (spmm_*, block_mix,
block_grams*, fused_iter) may exceed 1.10 x the faster of two copy rates
measured in the same window, of a state in device memory and of one that
fits the L2 cache.  A row that does can only be a timing that did not
resolve, and the run exits non-zero after printing its campaign.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from lanczos_tpu_torch.benchmarks import (
    add_device_argument,
    copy_rate,
    format_row,
    resolve_device,
    write_json,
)
from lanczos_tpu_torch.benchmarks.sweep_lanczos import iteration_slope
from lanczos_tpu_torch.utils.bench_loop import slope_time, slope_time_chain

NCOLS = [2, 4, 6, 8, 10, 12, 14, 16, 18]
GUARD_MARGIN = 1.10
PHYSICAL = ("spmm_", "block_mix", "block_grams", "fused_iter")


def _randn(shape, device, dtype=torch.float32, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype).to(device)


def norm_scale(mm, x, iters: int = 12) -> float:
    """1 / (1.05 ||A||), ||A|| estimated by power iteration from x: folded
    into a chained operator, it keeps every chain length finite."""
    y = x / x.norm()
    est = 1.0
    for _ in range(iters):
        z = mm(y)
        est = z.norm().item()
        y = z / est
    return 1.0 / (1.05 * est)


def bound_scale(a_sp) -> float:
    """1 / max(||A||_1, ||A||_inf) of a scipy matrix, at most 1 / ||A||_2:
    folded into a chained operator, it keeps every chain length finite."""
    a = abs(a_sp)
    return 1.0 / max(a.sum(axis=0).max(), a.sum(axis=1).max())


def bench_mm_tt(args, dev):
    """R = T^T T (reference mm_tt.hpp) on the block-major (p, n) layout."""
    out = []
    for p in NCOLS:
        t = _randn((p, args.rows), dev)
        s = slope_time(lambda t: t @ t.T, t)
        nbytes = 2 * args.rows * p * 4  # reference model: T counted twice
        out.append({"n_col": p, "seconds": s, "gbps": nbytes / s / 1e9,
                    "gflops": 2.0 * args.rows * p * p / s / 1e9})
    return out


def bench_mm_tt2(args, dev):
    """R = 1/2 (T1^T T2 + T2^T T1) (reference mm_tt2.hpp)."""
    out = []
    for p in NCOLS:
        t1, t2 = _randn((p, args.rows), dev), _randn((p, args.rows), dev, seed=1)

        def f(t1, t2):
            g = t1 @ t2.T
            return 0.5 * (g + g.T)

        s = slope_time(f, t1, t2)
        out.append({"n_col": p, "seconds": s,
                    "gbps": 2 * args.rows * p * 4 / s / 1e9,
                    "gflops": 2.0 * args.rows * p * p / s / 1e9})
    return out


def bench_mm_ts(args, dev):
    """R -= S^T R (reference mm_ts.hpp mm_ts2), chained."""
    out = []
    n = args.rows_ts
    for p in NCOLS:
        r = _randn((p, n), dev)
        s_small = _randn((p, p), dev, seed=1) * 1e-3
        sec = slope_time_chain(lambda r: r - s_small.T @ r, r, damp=None)
        out.append({"n_col": p, "seconds": sec, "gbps": 3 * n * p * 4 / sec / 1e9,
                    "gflops": 2.0 * n * p * p / sec / 1e9})
    return out


def bench_sqrtm(args, dev):
    """sqrtm + inverse sqrtm of one N_COL x N_COL SPD matrix (reference
    my_sqrtm_cusolver.hpp), per backend; chained through a normalized
    sqrtm + inverse, which stays SPD.  The jacobi rows are S1 (one launch
    on the card) with, beside it, `seconds_plain`: its plain version, the
    op-by-op torch Jacobi (on the CPU the two are the same code); lax is
    torch.linalg.eigh with the same epilogue."""
    from lanczos_tpu_torch.ops.kernels.smalleig import jacobi_sqrtm_plain
    from lanczos_tpu_torch.ops.smalleig import sqrtm_invsqrtm

    def chained(sqrtm):
        def step(a):
            sq, inv = sqrtm(a)
            g = sq + inv
            return g / torch.trace(g)
        return step

    out = []
    for backend in ("jacobi", "newton", "lax"):
        for p in NCOLS:
            g = _randn((256, p), dev)
            a = g.T @ g + p * torch.eye(p, device=dev)
            a = a / torch.trace(a)
            row = {"backend": backend, "n_col": p, "seconds": slope_time_chain(
                chained(lambda x, b=backend: sqrtm_invsqrtm(x, backend=b)), a,
                damp=None)}
            if backend == "jacobi":
                row["seconds_plain"] = slope_time_chain(
                    chained(jacobi_sqrtm_plain), a, damp=None)
            out.append(row)
    return out


def _spmm_rows(op, rows, nnz, nbytes, widths, dev, fixture=None, extra=None):
    """Chained SpMM rows of `op` (already scaled) at each width."""
    out = []
    for p in widths:
        x = _randn((rows,) if p == 1 else (p, rows), dev)
        step = (lambda y, a: a.mv(y)) if p == 1 else (lambda y, a: a.mm(y))
        s = slope_time_chain(step, x, op, damp=None)
        row = {} if fixture is None else {"fixture": fixture}
        row |= {"n_col": p, "rows": rows, "seconds": s,
                "nnz_per_s": nnz * p / s, "gbps": nbytes(p) / s / 1e9,
                "gflops": 2.0 * nnz * p / s / 1e9}
        out.append(row | (extra or {}))
    return out


def bench_spmm_ell(args, dev):
    """Gathered ELL SpMM on the Maxwell matrix (reference ell::SpMM),
    assembled at width 4 by the native engine."""
    from lanczos_tpu_torch.models.maxwell import maxwell_ell_operator
    from lanczos_tpu_torch.ops.formats import EllMatrix

    t0 = time.perf_counter()
    a = maxwell_ell_operator(args.grid_ell, args.grid_ell, args.grid_ell, device=dev)
    build_s = time.perf_counter() - t0
    rows = a.shape[0]
    a = EllMatrix(a.data * norm_scale(a.mm, _randn((1, rows), dev)), a.indices,
                  rows, rows)
    nnz = a.padded_rows * a.width
    # reference model (spmv_spmm.cu): data + idx + x gathers + y write
    return _spmm_rows(a, rows, nnz, lambda p: nnz * 8 + rows * p * 4 * 2,
                      [1] + NCOLS, dev, extra={"build_seconds": build_s})


def bench_spmm_dia(args, dev):
    """DIA SpMV/SpMM on a 2-D Laplacian: shifted-slice multiply-adds."""
    from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
    from lanczos_tpu_torch.ops.formats import dia_from_scipy

    a_sp = laplacian_2d_scipy(args.grid_dia, args.grid_dia)
    a = dia_from_scipy(a_sp * bound_scale(a_sp), device=dev)
    rows, ndiag = a.shape[0], len(a.offsets)
    return _spmm_rows(a, rows, a_sp.nnz, lambda p: (ndiag + 2) * rows * p * 4,
                      [1, 2, 4, 8], dev, extra={"ndiag": ndiag})


def _blockstruct(lap, bs, rng):
    import scipy.sparse as sp

    nbr = max(lap.shape[0] // bs, 2)
    tri = sp.diags([np.ones(nbr - 1), np.ones(nbr), np.ones(nbr - 1)],
                   [-1, 0, 1], format="csr")
    dense = rng.standard_normal((tri.nnz, bs, bs)) * 0.1
    return sp.bsr_matrix((dense, tri.indices, tri.indptr),
                         shape=(nbr * bs, nbr * bs)).tocsr()


def bench_spmm_bsr(args, dev):
    """BSR SpMM (BASELINE config 3's format) on a block-tridiagonal matrix
    of dense blocks and on a point Laplacian, per engine: 'windowed' (K8
    behind a BSR face) and 'einsum' (gather + einsum).  The windowed
    engine refuses rows wider than its planes-per-chunk cap (48; the 32 x
    32 blocks give 96 entries a row): such a row records the refusal."""
    from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
    from lanczos_tpu_torch.ops.formats import bsr_from_scipy
    from lanczos_tpu_torch.ops.window_ell import PlanError

    rng = np.random.default_rng(0)
    lap = laplacian_2d_scipy(args.grid_dia, args.grid_dia)
    out = []
    for name, sizes in (("blockstruct", [8, 16, 32]), ("laplacian_2d", [8])):
        for bs in sizes:
            a_sp = _blockstruct(lap, bs, rng) if name == "blockstruct" else lap
            for engine in ("windowed", "einsum"):
                try:
                    a = bsr_from_scipy(a_sp * bound_scale(a_sp), block_size=bs,
                                       engine=engine, device=dev)
                except PlanError as e:
                    out.append({"fixture": name, "engine": engine,
                                "block_size": bs, "refused": str(e)})
                    continue
                rows = a.shape[0]
                if engine == "einsum":
                    stored = a.data.numel()
                    mat_bytes = stored * 4 + a.block_cols.numel() * 4
                else:
                    stored = a.base.planes_data.numel()
                    mat_bytes = stored * 5
                for row in _spmm_rows(a, rows, a_sp.nnz,
                                      lambda p: mat_bytes + 2 * rows * p * 4,
                                      [4, 8], dev, fixture=name):
                    out.append({"engine": engine, "block_size": bs,
                                "stored_nnz": stored} | row)
    return out


def bench_spmm_stencil(args, dev, dtype=torch.float32):
    """The Maxwell stencil SpMM, K1, with the copy rate of the same state
    measured in the same window beside each row (`pct_of_copy`).  Bytes
    count the state's own element size (2 for a bf16 state)."""
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator

    N = args.grid
    op = PallasMaxwellOperator.create(N, N, N, dtype=dtype, device=dev)
    x1 = op.pack(_randn((op.n,), dev))
    damped = op.scaled(norm_scale(op.mv, x1))
    rows, out = op.n, []
    for p in [1, 2, 4, 8]:
        x = op.pack(_randn((rows,) if p == 1 else (p, rows), dev))
        bs = x.element_size()
        step = (lambda y, a: a.mv(y)) if p == 1 else (lambda y, a: a.mm(y))
        s = slope_time_chain(step, x, damped, damp=None)
        state_rate = 2 * x.numel() * bs / s / 1e9  # physical padded, r+w
        row = {"n_col": p, "rows": rows, "seconds": s,
               "nnz_per_s": 4 * rows * p / s,
               "gbps": 2 * rows * p * bs / s / 1e9,
               "gflops": 8.0 * rows * p / s / 1e9}
        if dev.type == "cuda":
            rate = copy_rate(x)
            row |= {"copy_gbps_same_window": rate, "pct_of_copy": 100.0 * state_rate / rate}
        out.append(row)
    return out


def bench_spmm_windowed(args, dev):
    """The windowed-ELL SpMM, K8, on the 2-D Laplacian and the width-4
    Maxwell matrix (N = --grid-windowed, 64 as in JAX) in the z-interleaved
    ordering (planes/chunk == ELL width) and through plain RCM (the
    ordering-sensitivity row)."""
    from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
    from lanczos_tpu_torch.models.maxwell import (
        maxwell_ell_operator,
        maxwell_interleave_perm,
    )
    from lanczos_tpu_torch.ops.formats import EllMatrix
    from lanczos_tpu_torch.ops.window_ell import windowed_from_ell, windowed_from_scipy

    N = args.grid_windowed
    ell = maxwell_ell_operator(N, N, N, device=dev)
    n = ell.shape[0]
    ell = EllMatrix(ell.data * norm_scale(ell.mm, _randn((1, n), dev)),
                    ell.indices, n, n)
    lap = laplacian_2d_scipy(args.grid_dia, args.grid_dia)
    fixtures = [
        ("laplacian_2d", windowed_from_scipy(
            (lap * bound_scale(lap)).astype(np.float32), device=dev)),
        ("maxwell_w4", windowed_from_ell(ell, perm=maxwell_interleave_perm(N, N, N))),
        ("maxwell_w4_rcm", windowed_from_ell(ell, reorder="rcm")),
    ]
    out = []
    for name, a in fixtures:
        rows, nnz = a.shape[0], a.nnz
        mat_bytes = sum(t.numel() * t.element_size() for t in
                        (a.planes_data, a.planes_lidx, a.planes_off, a.wb))
        for p in [1, 4, 8, 16]:
            x = a.pack(_randn((p, rows), dev))
            s = slope_time_chain(lambda y, a_: a_.padded_mm(y), x, a, damp=None)
            out.append({"fixture": name, "n_col": p, "rows": rows, "ppc": a.ppc,
                        "seconds": s, "nnz_per_s": nnz * p / s,
                        "gbps": (mat_bytes + 2 * x.numel() * 4) / s / 1e9,
                        "gflops": 2.0 * nnz * p / s / 1e9})
    return out


def bench_copy_bw(args, dev):
    """The copy rate y <- 1 - y (one read, one write of the state) at the
    reference's SpMM state sizes; p=1 streams a 4x longer state, so that it
    does not sit in the L2 cache."""
    out = []
    for p in [1, 4, 8]:
        n = args.rows_copy * 4 if p == 1 else args.rows_copy
        x = _randn((n,) if p == 1 else (p, n), dev)
        s = slope_time_chain(lambda y: 1.0 - y, x, damp=None)
        out.append({"n_col": p, "rows": args.rows_copy, "rows_streamed": n,
                    "seconds": s, "copy_gbps": 2 * n * p * 4 / s / 1e9})
    return out


def bench_block_mix(args, dev):
    """K2: out[j] = sum_k E[k, j] cat(u1, u2, u3)[k] on flat (p, n) states,
    into a fresh buffer and in place (onto u1: the fused step's form).
    Traffic: 3 reads + 1 write."""
    from lanczos_tpu_torch.ops.kernels.block_dense import block_mix

    out = []
    for p in NCOLS:
        u1, u2, u3 = (_randn((p, args.rows), dev, seed=s) for s in range(3))
        e = torch.eye(3 * p, p, device=dev) * 0.57
        nbytes = 4 * args.rows * p * 4
        row = {"n_col": p, "rows": args.rows}
        for label, ip in (("", False), ("_inplace", True)):
            s = slope_time_chain(
                lambda y, a_, b_, ip=ip: block_mix(e, (y, a_, b_), inplace=ip),
                u1, u2, u3, damp=None)
            row["seconds" + label] = s
            row["gbps" + label] = nbytes / s / 1e9
        out.append(row)
    return out


def bench_block_grams(args, dev, compensated=False):
    """K3 (or K7): [gram(x, z); gram(z, z)] on flat (p, n) states.
    Traffic: 2 reads.  K7's campaign runs p <= 8, as the JAX one."""
    from lanczos_tpu_torch.ops.kernels.block_dense import (
        block_grams,
        block_grams_compensated,
    )

    g = block_grams_compensated if compensated else block_grams
    out = []
    for p in [p for p in NCOLS if p <= 8] if compensated else NCOLS:
        x, z = _randn((p, args.rows), dev), _randn((p, args.rows), dev, seed=1)
        s = slope_time(lambda y, z_: g((y,), z_, include_zz=True), x, z)
        out.append({"n_col": p, "rows": args.rows, "seconds": s,
                    "gbps": 2 * args.rows * p * 4 / s / 1e9,
                    "gflops": 2.0 * 2 * args.rows * p * p / s / 1e9})
    return out


def bench_fused_iter(args, dev):
    """Per-iteration time of the fused block-Lanczos recurrence on the
    Maxwell operator: the two-call mono step (K2 in place, then K4) against
    the 3-call step (K2, K1, K3), as (t(m2) - t(4)) / (m2 - 4), m2 from 12
    up until the difference clears 25 ms (`sweep_lanczos.iteration_slope`).
    The mono step exists at p = 2..8 (K4's instantiations); at p = 1 and 16
    the row has NaN in its mono column and says which route ran."""
    from lanczos_tpu_torch.methods.block_lanczos_fused import block_lanczos_fused
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator

    class NoMono(PallasMaxwellOperator):
        def supports_stencil_gram(self, p, dtype=None):
            return False

    N = args.grid
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    op_3call = NoMono(op.nx, op.ny, op.nz, op.wz_t, op.wplane_s,
                      (op.spec_e, op.spec_h))
    out = []
    for p in [1, 2, 4, 8, 16]:
        b = op.pack(_randn((p, op.n), dev))
        mono_ok = p >= 2 and op.supports_stencil_gram(p)

        def iter_s(o):
            return iteration_slope(lambda m: block_lanczos_fused(o, b, m, 0),
                                   4, 12, dev)[0]

        s_mono = iter_s(op) if mono_ok else math.nan
        s_old = iter_s(op_3call)
        state = b.numel() * b.element_size()
        row = {"n_col": p, "rows": op.n, "state_mb": state / 1e6,
               "route": "mono, 3-call" if mono_ok else "3-call only",
               "seconds_mono": s_mono, "seconds_3call": s_old,
               "speedup": s_old / s_mono, "gbps_agg_7pass": 7 * state / s_mono / 1e9}
        if dev.type == "cuda":
            row["copy_gbps_same_window"] = copy_rate(b)
        out.append(row)
    return out


def bench_dtype_f64(args, dev):
    """Block Lanczos per iteration (materialized, p=4) on the flat Maxwell
    operator at N=24, f32 against f64, in the same window."""
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.models.maxwell import MaxwellOperator

    out = []
    for dt in (torch.float32, torch.float64):
        op = MaxwellOperator.create(24, 24, 24, dtype=dt, device=dev)
        b = _randn((4, op.n), dev, dtype=dt)
        sec, _ = iteration_slope(lambda m: block_lanczos(op, b, m, 0, fused=False),
                                 3, 7, dev)
        out.append({"dtype": str(dt).split(".")[-1], "rows": op.n, "n_col": 4,
                    "seconds_per_iter": sec})
    out[-1]["slowdown_vs_f32"] = out[1]["seconds_per_iter"] / out[0]["seconds_per_iter"]
    return out


BENCHES = {
    "mm_tt": bench_mm_tt,
    "mm_tt2": bench_mm_tt2,
    "mm_ts": bench_mm_ts,
    "sqrtm": bench_sqrtm,
    "spmm_ell": bench_spmm_ell,
    "spmm_dia": bench_spmm_dia,
    "spmm_stencil": bench_spmm_stencil,
    # bf16 states halve the bytes of the memory-bound K1 (JAX
    # bench_spmm_stencil_bf16)
    "spmm_stencil_bf16": lambda args, dev: bench_spmm_stencil(
        args, dev, dtype=torch.bfloat16),
    "spmm_windowed": bench_spmm_windowed,
    "spmm_bsr": bench_spmm_bsr,
    "copy_bw": bench_copy_bw,
    "block_mix": bench_block_mix,
    "block_grams": bench_block_grams,
    "block_grams_compensated": lambda args, dev: bench_block_grams(
        args, dev, compensated=True),
    "fused_iter": bench_fused_iter,
    "dtype_f64": bench_dtype_f64,
}


def copy_ceiling(dev) -> float:
    """The faster of two same-window copy rates (GB/s): a state in device
    memory (384 MB or more) and one that fits the card's L2 cache."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    x = _randn((max(l2 // 16, 1024),), dev)  # 1/4 of L2 read + written
    return max(copy_rate(x), copy_rate(x, min_bytes=0))


def roofline_violations(name, rows, ceiling: float) -> list:
    """Rows of a physical campaign whose GB/s exceeds the guard."""
    if not name.startswith(PHYSICAL):
        return []
    return [r for r in rows if any(
        isinstance(v, float) and k.startswith("gbps") and v > GUARD_MARGIN * ceiling
        for k, v in r.items())]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.benchmarks.kernel_bench")
    ap.add_argument("--rows", type=int, default=10_000_000)  # mm_tt ref size
    ap.add_argument("--rows-ts", type=int, default=3_000_000)  # mm_ts ref size
    ap.add_argument("--grid", type=int, default=160)  # spmv ref N=160
    ap.add_argument("--grid-ell", type=int, default=64)
    ap.add_argument("--grid-dia", type=int, default=1268)  # ~1.6M rows
    ap.add_argument("--grid-windowed", type=int, default=64)  # spmm_windowed Maxwell
    ap.add_argument("--rows-copy", type=int, default=24_600_000)  # ref state
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(BENCHES))
    ap.add_argument("--json", default=None, help="also write the results here")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = args.only.split(",") if args.only else list(BENCHES)
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown campaign(s) {unknown}")

    results = {}
    for name in names:
        print(f"== {name} ==", flush=True)
        rows = BENCHES[name](args, dev)
        results[name] = rows
        for r in rows:
            print("  " + format_row(r), flush=True)
        if dev.type == "cuda":
            ceiling = copy_ceiling(dev)
            bad = roofline_violations(name, rows, ceiling)
            if bad:
                write_json(args.json, results)
                raise SystemExit(
                    f"ROOFLINE VIOLATION in {name}: {bad[0]} exceeds "
                    f"{GUARD_MARGIN} x the same-window copy rate {ceiling:.1f} "
                    "GB/s: the timing did not resolve")
    write_json(args.json, results)
    return results


if __name__ == "__main__":
    main()
