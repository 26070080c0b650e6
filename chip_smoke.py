#!/usr/bin/env python3
"""Smoke test of lanczos_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  Phases, each of which must pass:

1. environment: torch / CUDA / nvcc / triton versions, the card's name and
   power limit;
2. build: the eight hand-written CUDA kernels (K1-K8) from
   lanczos_tpu_torch/csrc, with nvcc's register/spill report, and beside
   them (g++, in a second thread) the C++ host engine
   (lanczos_tpu_torch/native), each with its seconds;
3. kernel vs plain: each stencil-path kernel (K1-K5, K7) against its plain
   PyTorch version on the card, at the main paths' shapes (Maxwell N=160
   at p=4, the block slices, and at p=1, the vector slice; K4 and K7 at
   p=4 only, the vector slice runs neither) and at small geometries that
   K1/K5's strips must handle: N=11 (p=3, f32 and f64; K7 takes f32
   only), N=3 (a 128-lane plane, narrower than a strip; p=2), a
   non-cubic 37 x 24 x 11 grid (P=1152, no multiple of the strip; p=3,
   f64) and p=5 (N=11, f32), with the tolerance stated below; at N=160
   timed against its plain version and against a device copy of the
   same bytes; K7 also against the f64 Gram on inputs spread over
   e^+-6, at a bound that K3's f32 sums must miss; K4 launched twice on
   the same inputs (v and g3 bit-equal), and at a wide plane (317 x 49 x
   4, p=2) and at N=160 p=8 against its plain version; K6, the generic
   stencil, against its plain version at every small geometry above (the
   unpaired pair, two half-calls) and at small geometries of its own
   (6 -> 3 fields with 27 taps per output, a 7-point 1 -> 1 set, an odd
   Zc; p=1 and p=3; f32 and f64), then at the Maxwell N=160 p=4
   half-call, timed;
4. native: the 10,485,760-row synthetic matrix planned twice, by the C++
   engine and by its NumPy version (`packer="numpy"`): the plans'
   arrays must be bit-equal; both host times printed.  The native plan
   is the one phases 4 and 8 use;
   K8 vs plain: the windowed-ELL SpMM at small odd geometries (a 300x900
   random matrix, a 500x500 unstructured one, an RCM-permuted band, 997
   rows of a band; p=3 and p=1, f32 and f64), then at the assembled
   slice's shape (the synthetic SuiteSparse-style matrix, 10,485,760 rows,
   ~115M nnz), p=8 and p=1, timed against its plain version, a device
   copy of the same state and cuSPARSE (`torch.sparse.mm` on a CSR tensor,
   reported only); at p=8 also against scipy's f64 product on the host;
5. the block slice end to end through the CLI's `run`: N=160, m=6, p=4,
   --operator pallas, 2000 FDTD steps.  It checks that the path went
   through K1-K5 (the stencil_gram count equals m - 2: the fused mono step
   ran; K1 only in Lanczos, K5 for every FDTD step), that the solution is
   finite and that its relative error against the FDTD oracle is under
   1e-3;
6. the vector slice (--vector, m=8): the fused route at block width 1, K1,
   K2, K3 every step, no K4, K5 for every FDTD step;
7. the compensated slice (--compensated, m=6, p=4): the 3-call fused step
   with K7 for every Gram (m + 1 calls) and no K3 or K4;
7b. bf16 folded-plane states (`PallasMaxwellOperator.create(dtype=
   torch.bfloat16)`: f32 weights, f32 sums, bf16 storage) at N=160: K1
   at p=8 and p=1, K2 and K3 at p=1 (the fused vector route's calls) and
   K7 at p=4, each against its plain version (K1, K2 within one bf16 ulp;
   K3 within f32 K3's KERNEL_RTOL; K7 within K7_RTOL), timed against it and
   against a device copy of the same bytes; the vector slice's fused
   route (vector_lanczos, m=8, from the CLI's start vector): K1, K2, K3
   bf16 on every step and no other kernel, beta_0 within one bf16 ulp of
   the f32 slice's and its first step within 2e-2 of scale (every step's
   distance logged), A b within JAX's 5e-2 of the f32 operator's; 50 FDTD
   steps at p=4 (K1 bf16 every step, no K5) against the same loop with
   K1's plain version (2e-2 of scale), ms a step beside f32's K5; and
   block_lanczos(compensated=True) at p=4 (K7 bf16 m + 1 times, K1 and K2
   bf16 m times), finite, its distance from f32 logged;
8. the assembled slice: `block_lanczos_eigsh` (p=8, m=12, k=5, reorth
   full, TSQR, breakdown_eps 1e-4, replace_dead) on the padded windowed
   operator of the 10.5M-row matrix, then `ritz_residuals`: K8 exactly 12
   times in the recurrence and once more for the residuals, all five
   measured residuals under 1e-3; then `lanczos_eigsh` on the same
   operator (p=1, m=96, k=5, reorth full): K8 at p=1 in every one of its
   96 products and once more for the residuals' k=5 block, all five
   measured residuals under 1e-3; the block eigsh at
   262,144 rows against scipy's eigsh (top-5 to 1e-4), and a .mtx round
   trip through `operator_from_file(format="windowed")`;
8b. multidevice windowed (the row-sharded windowed-ELL operator,
   `lanczos_tpu_torch/parallel/dist_windowed.py`, on the assembled slice's
   matrix, f32, p=8): its 4 `HaloShardedWindowed` shards (halo 4999, one
   hop, strips of 2,654,208) planned in this process on the one card,
   each work strip's halo slots filled by hand from its neighbours' rows,
   K8 on each, the products stitched and held to phase 4's single-device
   K8 product (KERNEL_RTOL; bit-equality reported), every halo slot and
   pad row exactly zero, each shard's K8 against its plain version; each
   shard's K8 and its work copy timed (an interior shard also against its
   plain version, its bound and cuSPARSE on its CSR rows); JAX's
   test_matches_single_chip_windowed matrix (n=900, band 300) on 4
   shards of 256 rows (halo 288, 2 hops) against scipy; then world size
   1 through `launch.run` on NCCL: the assembled slice's
   `block_lanczos_eigsh` on `HaloShardedWindowed` with its start block,
   K8 exactly 12 times in the recurrence and 13 in all and no other
   kernel (counts read from 0 in the rank, and added to the kernels
   line), Ritz values within EIGSH_RTOL of phase 8's, measured residuals
   under 1e-3; a `block_lanczos_checkpointed` run stopped after its first
   chunk and resumed, against `block_lanczos(fused=False)`;
   `operator_from_file(mesh=, format="windowed"/"auto")` and
   `auto_operator(mesh=)` on a small .mtx; the dry run's three steps
   (`parallel/dryrun.py`);
8c. multidevice ell (the row-sharded ELL operators,
   `lanczos_tpu_torch/parallel/dist_operator.py`, on the assembled slice's
   matrix, f32, p=8): its 4 `halo_shard`s (halo 4999, one hop) built in
   this process on the one card, each window filled by hand from its
   neighbours' rows, the local products stitched and held to the
   single-device `EllMatrix` product (1e-5 of scale; bit-equal expected)
   and to K8's (KERNEL_RTOL), each shard and the whole timed; an arrow
   matrix on 4 shards (halo 768, 3 hops) against scipy, its pad rows
   zero; then world size 1 through `launch.run` on NCCL: the assembled
   slice's `block_lanczos_eigsh` on `HaloShardedEll` with its start
   block, Ritz values within EIGSH_RTOL of phase 8's K8 run, measured
   residuals under 1e-3, no kernel of the repo launched (the local
   product is plain torch, as it is XLA in the JAX package; counts read
   from 0 in the rank), one `GatherShardedEll` product against the halo
   product, and a `block_lanczos_checkpointed` run stopped after its
   first chunk and resumed, against `block_lanczos(fused=False)`; the
   eigsh's wall seconds and peak device memory;
9. the ELL slice at the reference's N=160 (24.6M rows): the width-4 ELL
   operator built by the C++ engine straight from the taps (its seconds
   logged), A X at p=4 against K1's A X on the same state (tolerance
   below; both timed), then `--operator ell` (N=160, m=6, p=4, 2000 FDTD
   steps): the gathered ELL product is plain torch, and the 394 MB block
   state passes the 16 MB gate, so the fused recurrence runs K2/K3 on
   flat (p, n) states; relative error under 1e-3;
10. the unpaired pair: A U at N=160 p=4 through `apply_stencil_pair`
    with paired=False on both halves, two K6 launches and no K1, within
    1e-5 of K1's paired A U, both timed; then K5 and K4 with the same
    unpaired specs, each one launch of its own kernel, against its plain
    version;
11. checkpoint/resume at N=160 p=4: `block_lanczos_checkpointed` (m=6,
    chunk 3) against `block_lanczos(fused=False)`; a run stopped at j=4
    and resumed, and an FDTD run (2000 steps, chunks of 1000) stopped
    after its first chunk and resumed, each equal to its uninterrupted
    run bit for bit (K5 2000 times); the seconds and MB of every save;
12. the profile: the block slice's Lanczos through `run` with --profile
    and --no-validate; the Chrome trace names stencil_gram_kernel and
    the launch counts are the block slice's without its FDTD;
13. bench: `lanczos_tpu_torch.bench`'s measurement (Maxwell N=160, p=4,
    K1 chained, best of four slopes), its JSON line printed; its per-call
    time must agree with phase 3's K1 time (mean of 20 calls) within
    BENCH_RTOL; K1 is also timed by `utils.timing.benchmark_chained`, so
    that the three protocols stand side by side;
14. drivers: each benchmark driver's `main` once, at a cut size:
    `kernel_bench --only copy_bw,spmm_stencil,spmm_stencil_bf16,block_mix,
    block_grams`
    (--rows 4,000,000, --grid 96, --rows-copy 8,000,000; its roofline
    guard on), `sweep_lanczos` block p=4 at N = 64 and 80, `convergence`
    (N=3, f64, m <= 6, 100,000 FDTD steps: K5 and K1 in f64),
    `suitesparse_scale` at 262,144 rows (m=12, p=8: K8) with `--dist`
    (the windowed operator on every card, at most 8) and `tune_windowed`
    at 1,048,576 rows (K8 on the 12 cpb x spg plans), each with its
    launch counts and its own checks;
15. multidevice (the z-slab layer, `lanczos_tpu_torch/parallel`): K1 on
    each of 4 z-slabs of the N=160 p=4 state, built in this process on the
    one card with the halo planes copied in by hand from the neighbours'
    slabs, unpacked and held to the single-device K1 (MULTI_RTOL), its
    pads zero, timed against the whole-domain K1; then
    `DistributedPallasMaxwell` at world size 1 through `launch.run` on
    NCCL (one spawned rank): `block_lanczos_expm_action` (m=6, p=4) held
    to the single-device `fused=False` run (REL_ERROR_BOUND), both held
    to 2000 FDTD steps on the distributed operator (K1 plus an add a
    step), the rank's launch counts read from 0 around that run (K1 only,
    m + 2000 times), ms an iteration of both operators and of 50 FDTD
    steps; and `--devices` one more than the machine's cards is a
    ValueError before any rank starts.

Each slice phase (and phases 10-15) sets the launch counts to 0 just
before it drives its path and reads them just after.

The FDTD oracle's forward-Euler error falls as 1/steps; the CLI's default
is 10^6 steps, the smoke takes 2000 to fit its time budget.

Output: one JSON line of per-kernel results (launches summed over the
paths driven: slices, bench and drivers; bound_ms the larger of the bytes
over the card's memory rate and the operations over its peak rate; K1,
K2, K3, K5 and K8 also at p=1, in rows of their own that count the
launches at p=1 of the vector slices: the CLI's and the assembled
eigsh's; the bf16 kernels in rows of their own, "... bf16", counting
their bf16 launches), the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SLICE, P_SLICE, M_SLICE = 160, 4, 6
M_VECTOR = 8
FDTD_STEPS, LC = 2000, 20
REL_ERROR_BOUND = 1e-3  # as tests/test_cli.py
TIMED_LAUNCHES = 20
# kernel vs plain, relative to the plain result's largest |value|: the
# elementwise kernels (K1, K2, K5) differ from torch only by FMA
# contraction; the Gram sums (K3, K4) add ~28M products in another order;
KERNEL_RTOL = {"float32": 1e-5, "float64": 1e-12}
# K7 and its plain version both sum in f64 (in other orders) and round once
# to f32: an ulp or two of f32.  A K7 that summed in f32 would miss this by
# an order of magnitude (K3 sits at ~5e-6 of scale on the same inputs).
K7_RTOL = 3e-7
# K7 against the f64 Gram on wide-range inputs: an f64 sum rounded once to
# f32 is within 2^-24 (6e-8) of each entry.  Tighter than the JAX kernel's
# 5e-7 (tests/test_block_dense.py), which K3's f32 sums meet at N=160.
K7_ORACLE_RTOL = 1e-7
# the assembled slice: BASELINE.json config 4 on one card
N_ASSEMBLED, N_ASSEMBLED_SMALL = 10_485_760, 262_144
P_ASSEMBLED, M_ASSEMBLED, K_ASSEMBLED = 8, 12, 5
M_VECTOR_EIGSH = 96  # single-vector eigsh: the block slice's Krylov dimension
RESID_BOUND = 1e-3  # measured relative Ritz residuals, f32
EIGSH_RTOL = 1e-4  # top-5 against scipy's eigsh at 262,144 rows
# K8 at p=8 against scipy's f64 product: each row sums <= 15 f32 products
K8_SCIPY_RTOL = 1e-5
N_ELL, M_ELL = 160, 6  # the reference's 24.6M rows; over the 16 MB fused gate
# gathered ELL A X against K1's on the same state: each sums the same 4
# products per row; the ELL values are the taps' f64 product rounded once,
# K1 multiplies f32 z- and plane-weights, so a row differs by a few ulp
ELL_VS_K1_RTOL = 1e-5
# the bench's slope per call against phase 3's mean of 20 K1 calls: the
# same kernel on the same shape, timed two ways a few minutes apart
BENCH_RTOL = 0.10
# the drivers phase's cut sizes
DRIVER_CONVERGENCE_STEPS, DRIVER_CONVERGENCE_M = 100_000, 6
# the convergence driver at 10^5 steps: m >= 5 sits on the oracle's
# forward-Euler floor, ~10x the 10^6-step curve's 1.7e-9
DRIVER_CONVERGENCE_BOUND = 1e-7
DRIVER_TUNE_ROWS = 1_048_576
# the card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# device memory, and the non-tensor-core rate for each type of operation
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
SOURCE = "lanczos_tpu_torch/csrc/lanczos_kernels.cu"
REPLACES = {
    "apply_stencil_pair": "lanczos_tpu/ops/pallas/stencil_kernel.py:70",
    "block_mix": "lanczos_tpu/ops/pallas/block_dense.py:104",
    "block_grams": "lanczos_tpu/ops/pallas/block_dense.py:210",
    "apply_stencil_pair_gram": "lanczos_tpu/ops/pallas/stencil_gram.py:96",
    "fdtd_step": "lanczos_tpu/ops/pallas/stencil_fdtd.py:50",
    "block_grams_compensated": "lanczos_tpu/ops/pallas/block_dense.py:361",
    "windowed_spmm": "lanczos_tpu/ops/pallas/window_ell.py:691",
    "apply_stencil": "lanczos_tpu/ops/pallas/stencil_kernel.py:276",
}
# the kernels with a row of their own at p=1: K1, K2 and K3 run at p=1 in
# every step of the vector slice and K5 in every step of its FDTD, K8 in
# every step of the assembled vector eigsh
P1_ROWS = ("block_grams", "windowed_spmm", "apply_stencil_pair", "fdtd_step",
           "block_mix")
# the bf16 kernels' rows (K1 at p=8, and at p=1 with K2 and K3 in the bf16
# vector slice; K7 at p=4), keyed by their launch counters (build.LAUNCHES:
# bf16 launches count apart)
BF16_ROWS = ("apply_stencil_pair bf16", "apply_stencil_pair bf16 p=1",
             "block_mix bf16 p=1", "block_grams bf16 p=1",
             "block_grams_compensated bf16")
# phase 3's geometries: (nx, ny, nz), p, dtype name; the first is timed
KERNEL_CASES = (
    ((N_SLICE,) * 3, P_SLICE, "float32"),
    ((11, 11, 11), 3, "float32"),
    ((11, 11, 11), 3, "float64"),
    ((3, 3, 3), 2, "float32"),          # P=128: narrower than a strip
    ((37, 24, 11), 3, "float64"),       # xc != yc, P=1152
    ((11, 11, 11), 5, "float32"),       # p=5
)
# the unpaired pair (two K6 launches) against K1's factored A U, relative
# to the result's scale: the factoring changes the rounding only
UNPAIRED_RTOL = 1e-5
M_CHECKPOINT, CHUNK_CHECKPOINT, M_STOPPED = 6, 3, 4
# the multidevice phase: slabs of the slice's state, and its K1 tolerance
# (the same per-lane products as the whole-domain K1, on other rows)
MULTI_SLABS, MULTI_RTOL, MULTI_FDTD_TIMED = 4, 1e-5, 50


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, iters=TIMED_LAUNCHES, warmup=2):
    """Mean device milliseconds per call over `iters` back-to-back calls,
    timed with CUDA events after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def phase_environment(torch, build):
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout
    log("nvcc:", [ln for ln in ver.splitlines() if "release" in ln][0].strip())
    try:
        import triton

        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import ({e})")
    log("card:", torch.cuda.get_device_name(0), "count", torch.cuda.device_count())
    log("nvidia-smi:", nvidia_smi_line())


def phase_build(build):
    """nvcc builds the kernels while g++ builds the host engine in a
    second thread (both are subprocesses); a failure of either fails."""
    import threading

    from lanczos_tpu_torch import native

    native_error = []

    def build_native():
        t0 = time.perf_counter()
        try:
            native.library()
        except Exception:  # reported below, after the kernels' build
            native_error.append(traceback.format_exc())
        log(f"native engine build: {time.perf_counter() - t0:.2f} s "
            f"(g++ {native.build_seconds:.2f} s)")

    worker = threading.Thread(target=build_native)
    worker.start()
    t0 = time.perf_counter()
    try:
        build.library()
    finally:
        worker.join()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    if native_error:
        raise RuntimeError(f"the native engine did not build:\n{native_error[0]}")
    # ptxas -v: registers and spills per kernel instantiation, e.g.
    # "stencil_gram_kernel<f,4,0,1>: 127 registers, 0 bytes spill stores"
    # (type, MAXP, TILED, FULL), "gram_kernel<f,d,f,8,4,4>" (operand,
    # sum and output types, R, C, VEC) or "stencil_pair_kernel<bf16,f,2>"
    # (state and weight types, lanes a thread)
    name, spills = None, ""
    bf16 = "13__nv_bfloat16"
    for ln in build.build_log.splitlines():
        m = re.search(r"\d([a-z][a-z_]*_kernel)(?:I((?:13__nv_bfloat16|[fd])+)"
                      r"((?:L[ib]\d+E)*)E)?", ln)
        if "Compiling entry function" in ln and m:
            types = re.findall(bf16 + "|[fd]", m.group(2) or "")
            args = [("bf16" if t == bf16 else t) for t in types] + re.findall(
                r"L[ib](\d+)E", m.group(3) or "")
            name = f"{m.group(1)}<{','.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spills = m.group(0)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            log(f"  ptxas {name}: {m.group(1)} registers, {spills}")


def bound(nbytes, ops, ops_type):
    """The least time (ms) the card could take: the larger of the bytes
    over its memory rate and the operations over its peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[ops_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, err, ms, plain_ms, nbytes, ops, ops_type, library_ms,
               key=None):
    """One entry of the kernels JSON line; `key` names a second row of the
    same kernel (at p=1)."""
    bound_ms, bound_by = bound(nbytes, ops, ops_type)
    log(f"    bound {bound_ms:.4f} ms ({bound_by}), kernel at "
        f"{bound_ms / ms:.1%} of it; library "
        + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
    return dict(name=key or name, route="cuda", source=SOURCE,
                replaces=REPLACES[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def compare(torch, got, want, rtol):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-300)
    ok = math.isfinite(err) and err <= rtol * scale
    return err, err / scale, ok


def phase_kernels(torch, results, failures):
    """Each stencil-path kernel against its plain version, at the slices'
    shapes (timed) and at a small odd geometry.

    Operations per call, for the bound: a stencil output element costs 12
    (four taps, two multiplies and an add each), K5 one more (the identity
    term); a Gram or block_mix of K rows against p columns 2*K*p per state
    element of a column; K7's sums are f64 operations."""
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.ops.kernels import (
        block_dense,
        stencil_fdtd,
        stencil_gram,
    )
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
        apply_stencil_pair,
        apply_stencil_pair_plain,
    )

    dev = torch.device("cuda")

    def check(label, name, dtype_name, got, want):
        rtol = K7_RTOL if name == "block_grams_compensated" else KERNEL_RTOL[dtype_name]
        err, rel, ok = compare(torch, got, want, rtol)
        log(f"  {label}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {rtol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} disagrees with its plain version")
        return err

    rows = results.setdefault("rows", {})
    for geometry, p, dname in KERNEL_CASES:
        dtype = getattr(torch, dname)
        timed = geometry == (N_SLICE,) * 3
        log(f"kernels vs plain at {'x'.join(map(str, geometry))} p={p} {dname}")
        op = PallasMaxwellOperator.create(*geometry, dtype=dtype, device=dev)
        shape = (p,) + op.state_shape
        g = torch.Generator(device=dev).manual_seed(0)

        def rand(rows=p):
            # unit-norm block columns, the scale of the Lanczos basis, so
            # the Grams are O(1) as on the main path
            x = torch.randn((rows,) + op.state_shape, generator=g,
                            device=dev, dtype=dtype)
            return x / x.flatten(1).norm(dim=1).view(-1, 1, 1, 1)

        state_bytes = math.prod(shape) * torch.tensor([], dtype=dtype).element_size()
        S = math.prod(op.state_shape)  # elements of one block column

        def record(name, label, got, want, kernel_fn, plain_fn, nbytes, ops,
                   library_fn=None, ops_type=dname, key=None):
            err = check(label, name, dname, got, want)
            if not timed:
                return
            ms = cuda_ms(torch, kernel_fn)
            plain_ms = cuda_ms(torch, plain_fn)
            library_ms = None if library_fn is None else cuda_ms(torch, library_fn)
            log(f"    {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"{nbytes / 1e6:.1f} MB/call -> {nbytes / ms / 1e6:.1f} GB/s")
            row = kernel_row(name, err, ms, plain_ms, nbytes, ops, ops_type,
                             library_ms, key)
            rows.setdefault(key or name, row)

        if timed:
            src, dst = rand(), rand()
            copy_ms = cuda_ms(torch, lambda: dst.copy_(src))
            log(f"  device copy of one block state: {copy_ms:.4f} ms, "
                f"{2 * state_bytes / copy_ms / 1e6:.1f} GB/s (read + write)")
            del src, dst

        # K1, K2, K3 at the block width and, on the slice's geometry, at
        # p=1, the vector slice's fused route (K2 -> K1 -> K3 per step); the
        # JSON line keeps the block width's times, and K3's at p=1 in a row
        # of its own
        for pk in (p, 1) if timed else (p,):
            tag = f" p={pk}"
            pbytes = state_bytes * pk // p

            # K1: A u
            u = rand(pk)
            plain_k1 = lambda: apply_stencil_pair_plain(  # noqa: E731
                u, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
            record("apply_stencil_pair", "K1 apply_stencil_pair" + tag, op.mm(u),
                   plain_k1(), lambda: op.mm(u), plain_k1, 2 * pbytes,
                   12 * pk * S, key=None if pk == p else "apply_stencil_pair p=1")
            del u

            # K2: block_mix, 1-, 2- and 3-operand, and in place (the mono
            # form is the one timed at p=4: it runs every step there; p=1
            # runs the 3-operand form into a new buffer)
            # three operands in one buffer, so that cat(xs) is a view and
            # one torch.mm computes block_mix and the Gram (library_ms)
            stack = rand(3 * pk)
            xs = list(stack.split(pk))
            for k in (3, 1, 2):
                coeffs = 0.1 * torch.randn((k * pk, pk), generator=g, device=dev,
                                           dtype=dtype)
                ops = xs[:k]
                want = block_dense.block_mix_plain(coeffs, ops)
                if k == 3:
                    work = [x.clone() for x in ops]
                    got = block_dense.block_mix(coeffs, work, inplace=True)
                    assert got.data_ptr() == work[0].data_ptr()
                    label = "K2 block_mix 3 operands in place" + tag
                    if pk == p:
                        record("block_mix", label, got, want,
                               lambda: block_dense.block_mix(coeffs, work, inplace=True),
                               lambda: block_dense.block_mix_plain(coeffs, ops),
                               (k + 1) * pbytes, 2 * k * pk * pk * S,
                               lambda: coeffs.T @ stack.flatten(1))
                    else:
                        check(label, "block_mix", dname, got, want)
                    del work, got
                    got = block_dense.block_mix(coeffs, ops)
                    label = "K2 block_mix 3 operands" + tag
                    if pk == p:
                        check(label, "block_mix", dname, got, want)
                    else:
                        record("block_mix", label, got, want,
                               lambda: block_dense.block_mix(coeffs, ops),
                               lambda: block_dense.block_mix_plain(coeffs, ops),
                               (k + 1) * pbytes, 2 * k * pk * pk * S,
                               lambda: coeffs.T @ stack.flatten(1),
                               key="block_mix p=1")
                else:
                    got = block_dense.block_mix(coeffs, ops)
                    check(f"K2 block_mix {k} operand(s){tag}", "block_mix", dname,
                          got, want)
                del got, want

            # K3: block_grams with include_zz, as the prologue and every step
            # at p=1 and the peeled step at p=4
            q, v = xs[0], xs[1]
            record("block_grams", "K3 block_grams (q,), v, include_zz" + tag,
                   block_dense.block_grams((q,), v, include_zz=True),
                   block_dense.block_grams_plain((q,), v, include_zz=True),
                   lambda: block_dense.block_grams((q,), v, include_zz=True),
                   lambda: block_dense.block_grams_plain((q,), v, include_zz=True),
                   2 * pbytes, 2 * (2 * pk) * pk * S,
                   lambda: stack[: 2 * pk].flatten(1) @ v.flatten(1).T,
                   key=None if pk == p else "block_grams p=1")
            check("K3 block_grams (), b, include_zz" + tag, "block_grams", dname,
                  block_dense.block_grams((), q, include_zz=True),
                  block_dense.block_grams_plain((), q, include_zz=True))
            check("K3 block_grams (x0, x1, x2), z" + tag, "block_grams", dname,
                  block_dense.block_grams(tuple(xs), v),
                  block_dense.block_grams_plain(tuple(xs), v))
            del xs, q, v, stack

        # K4: v = A q into dst, plus [gram(q,v); gram(v,v); gram(dst_old,q)]
        q, dst = rand(), rand()
        want_v, want_g3 = stencil_gram.apply_stencil_pair_gram_plain(
            q, dst.clone(), op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
        work = dst.clone()
        got_v, got_g3 = op.stencil_gram(q, work)
        if got_v.data_ptr() != work.data_ptr():
            failures.append("K4 v does not alias dst")
        check("K4 apply_stencil_pair_gram v", "apply_stencil_pair_gram", dname,
              got_v, want_v)
        # a second launch on the same inputs: the same bits (no float
        # atomics; the blocks' partials add in block order)
        again = dst.clone()
        v2, g3_2 = op.stencil_gram(q, again)
        same = torch.equal(v2, got_v) and torch.equal(g3_2, got_g3)
        log(f"  K4 twice on the same inputs: v and g3 bit-equal {same}")
        if not same:
            failures.append("K4: two launches on the same inputs differ")
        del again, v2, g3_2
        scratch = dst.clone()
        record("apply_stencil_pair_gram", "K4 apply_stencil_pair_gram g3",
               got_g3, want_g3, lambda: op.stencil_gram(q, work),
               lambda: stencil_gram.apply_stencil_pair_gram_plain(
                   q, scratch, op.wz_t, op.wplane_s, op.spec_e, op.spec_h),
               3 * state_bytes, 12 * p * S + 3 * 2 * p * p * S)
        del q, dst, work, scratch, want_v, want_g3, got_v, got_g3

        # K6 on this geometry: the unpaired pair, one launch a half
        if not timed:
            u = rand()
            loose = [dataclasses.replace(sp, paired=False)
                     for sp in (op.spec_e, op.spec_h)]
            check("K6 unpaired pair (two half-calls)", "apply_stencil", dname,
                  apply_stencil_pair(u, op.wz_t, op.wplane_s, *loose),
                  apply_stencil_pair_plain(u, op.wz_t, op.wplane_s, *loose))
            del u

        # K5: out = u + (dt A) u into a second buffer, at the block width
        # and, on the slice's geometry, at p=1 (the vector slice)
        a_dt = op.scaled(1.0 / FDTD_STEPS)
        for pk in (p, 1) if timed else (p,):
            u, out = rand(pk), torch.empty((pk,) + op.state_shape, device=dev,
                                           dtype=dtype)
            plain_k5 = lambda: stencil_fdtd.fdtd_step_plain(  # noqa: E731
                u, torch.empty_like(u), a_dt.wz_t, a_dt.wplane_s, a_dt.spec_e,
                a_dt.spec_h)
            got = a_dt.fdtd_step(u, out)
            if got.data_ptr() != out.data_ptr():
                failures.append("K5 did not write its out buffer")
            record("fdtd_step", f"K5 fdtd_step p={pk}", got, plain_k5(),
                   lambda: a_dt.fdtd_step(u, out), plain_k5,
                   2 * state_bytes * pk // p, 13 * pk * S,
                   key=None if pk == p else "fdtd_step p=1")
            if timed and pk == p:
                # the two passes it replaces: K1 then an in-place add
                two_ms = cuda_ms(torch, lambda: u.clone().add_(a_dt.mm(u)))
                log(f"    two-pass step (clone + K1 + add) at p={pk}: {two_ms:.4f} ms")
            del u, out, got
        del a_dt

        # K7: the compensated Gram, f32 states only
        if dtype == torch.float32:
            q, v = rand(), rand()
            record("block_grams_compensated",
                   "K7 block_grams_compensated (q,), v, include_zz",
                   block_dense.block_grams_compensated((q,), v, include_zz=True),
                   block_dense.block_grams_compensated_plain((q,), v, include_zz=True),
                   lambda: block_dense.block_grams_compensated((q,), v, include_zz=True),
                   lambda: block_dense.block_grams_compensated_plain(
                       (q,), v, include_zz=True),
                   2 * state_bytes, 2 * (2 * p) * p * S, ops_type="float64")
            check("K7 block_grams_compensated (), b, include_zz",
                  "block_grams_compensated", dname,
                  block_dense.block_grams_compensated((), q, include_zz=True),
                  block_dense.block_grams_compensated_plain((), q, include_zz=True))
            del q, v
            if timed:
                k7_wide_range(torch, rand, failures)
        else:
            try:
                block_dense.block_grams_compensated((), rand(), include_zz=True)
                failures.append("K7 took an f64 state")
            except ValueError:
                log("  K7 refuses f64 states: ok")
        del op
        torch.cuda.empty_cache()
    k4_wide_and_p8(torch, failures)
    k6_vs_plain(torch, rows, failures)


def k4_wide_and_p8(torch, failures):
    """K4 against its plain version beyond the slice's shape: a wide plane
    (317 x 49 x 4: y-halos of 320 lanes) at p=2, and N=160 at p=8 (every
    column staged at once, the MAXP=8 instantiation), f32; v aliases dst,
    one launch each, the same bits on a repeat."""
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.ops.kernels import build, stencil_gram

    dev = torch.device("cuda")
    for geometry, p in (((317, 49, 4), 2), ((N_SLICE,) * 3, 8)):
        op = PallasMaxwellOperator.create(*geometry, device=dev)
        g = torch.Generator(device=dev).manual_seed(8)
        q, dst = (op.pack(torch.randn((p, op.n), generator=g, device=dev))
                  for _ in range(2))
        q /= q.flatten(1).norm(dim=1).view(-1, 1, 1, 1)
        dst /= dst.flatten(1).norm(dim=1).view(-1, 1, 1, 1)
        again = dst.clone()
        want_v, want_g3 = stencil_gram.apply_stencil_pair_gram_plain(
            q, dst.clone(), op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
        before = build.LAUNCHES["apply_stencil_pair_gram"]
        v, g3 = op.stencil_gram(q, dst)
        v2, g3_2 = op.stencil_gram(q, again)
        torch.cuda.synchronize()
        label = f"K4 at {'x'.join(map(str, geometry))} p={p} float32"
        ok = (v.data_ptr() == dst.data_ptr()
              and build.LAUNCHES["apply_stencil_pair_gram"] == before + 2
              and torch.equal(v, v2) and torch.equal(g3, g3_2))
        for part, got, want in (("v", v, want_v), ("g3", g3, want_g3)):
            err, rel, close = compare(torch, got, want, KERNEL_RTOL["float32"])
            log(f"  {label} {part}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
                f"{KERNEL_RTOL['float32']:.0e}) {'ok' if close else 'FAIL'}")
            ok = ok and close
        log(f"  {label}: aliases dst, one launch a call, bit-equal repeat: {ok}")
        if not ok:
            failures.append(f"{label} disagrees with its plain version or "
                            "does not repeat")
        del op, q, dst, again, v, v2, g3, g3_2, want_v, want_g3
        torch.cuda.empty_cache()


def k6_spec(kind, zc, plane):
    """K6's small geometries: "27-point 6->3" takes all 27 (dz, roll)
    combinations of a 3x3x3 neighbourhood for each of 3 output components
    (the lane roll of a y-shift is xc=13 lanes); "7-point 1->1" is a
    Laplacian-shaped tap set."""
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import StencilSpec

    xc = 13
    if kind == "27-point 6->3":
        nbhd = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)]
        taps = tuple((oc, (k + oc) % 6, dz, (-(dy * xc) - dx) % plane)
                     for oc in range(3) for k, (dz, dy, dx) in enumerate(nbhd))
        return StencilSpec(6, 3, taps, zc, plane)
    offs = ((0, 0), (-1, 0), (1, 0), (0, 1), (0, plane - 1), (0, xc),
            (0, plane - xc))
    return StencilSpec(1, 1, tuple((0, 0, dz, r) for dz, r in offs), zc, plane)


def k6_vs_plain(torch, rows, failures):
    """K6 against its plain version at small geometries (an odd Zc among
    them; p=1 and p=3; f32 and f64), then at the Maxwell N=160 p=4
    half-call (the E half, unpaired, reading components 3..5 and writing
    0..2 of one state), timed against its plain version and a device copy
    of the same bytes.  z-shifted taps carry zero z-weights on the rows
    where the shift leaves the state, as the Maxwell operator's do."""
    import dataclasses

    import numpy as np

    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
        apply_stencil,
        apply_stencil_plain,
        stencil_into,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def check(label, dname, got, want):
        err, rel, ok = compare(torch, got, want, KERNEL_RTOL[dname])
        log(f"  {label}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {KERNEL_RTOL[dname]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} disagrees with its plain version")
        return err

    log("K6 apply_stencil vs plain at small geometries")
    for kind, zc in (("27-point 6->3", 16), ("7-point 1->1", 16),
                     ("27-point 6->3", 13)):
        spec = k6_spec(kind, zc, 256)
        wz = rng.standard_normal((len(spec.taps), zc))
        for t, (_, _, dz, _) in enumerate(spec.taps):
            if dz:
                wz[t, 0 if dz == -1 else -1] = 0.0
        wp = rng.standard_normal((len(spec.taps), spec.plane))
        for p in (1, 3):
            x = rng.standard_normal((p, spec.n_in, zc, spec.plane))
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[-1]
                args = [torch.from_numpy(a).to(dev, dtype) for a in (x, wz, wp)]
                check(f"K6 {kind} Zc={zc} P={spec.plane} p={p} {dname}", dname,
                      apply_stencil(*args, spec), apply_stencil_plain(*args, spec))

    log(f"K6 at the Maxwell N={N_SLICE} p={P_SLICE} half-call (E half, unpaired)")
    op = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device=dev)
    spec = dataclasses.replace(op.spec_e, paired=False)
    wz, wp = op.wz_t[0].T, op.wplane_s[0]
    g = torch.Generator(device=dev).manual_seed(3)
    u = torch.randn((P_SLICE,) + op.state_shape, generator=g, device=dev)
    out = torch.zeros_like(u)
    half = lambda: stencil_into(u[:, 3:6], out[:, 0:3], wz, wp, spec)  # noqa: E731
    plain = lambda: apply_stencil_plain(u[:, 3:6], wz, wp, spec)  # noqa: E731
    half()
    err = check("K6 Maxwell E half p=4 float32", "float32", out[:, 0:3], plain())
    if torch.count_nonzero(out[:, 3:6]):
        failures.append("K6 wrote outside its output components")
    ms, plain_ms = cuda_ms(torch, half), cuda_ms(torch, plain)
    src = u[:, 3:6].contiguous()
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(torch, lambda: dst.copy_(src))
    nbytes = 2 * src.numel() * 4 + (wz.numel() + wp.numel()) * 4
    log(f"    K6 half-call: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, copy of "
        f"the same bytes {copy_ms:.4f} ms; {nbytes / 1e6:.1f} MB/call -> "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    # each tap: two multiplies and an add per element of its output field
    rows["apply_stencil"] = kernel_row(
        "apply_stencil", err, ms, plain_ms, nbytes,
        3 * len(spec.taps) * P_SLICE * spec.zc * spec.plane, "float32", None)
    del op, u, out, src, dst
    torch.cuda.empty_cache()


def k7_wide_range(torch, rand, failures):
    """K7 against the f64 Gram on block states whose entries spread over
    e^+-6, where f32 sums lose more than one rounding (tests/
    test_block_dense.py).  K3, which sums in f32, must miss the
    same bound on the same inputs, or the check would not tell a K7 that
    summed in f32 from one that sums in f64."""
    from lanczos_tpu_torch.ops.kernels import block_dense

    g = torch.Generator(device="cuda").manual_seed(1)

    def wide():
        x = rand()
        return x * torch.empty_like(x).uniform_(-6, 6, generator=g).exp_()

    x, z = wide(), wide()
    exact = x.flatten(1).double() @ z.flatten(1).double().T
    err, rel, ok = compare(torch, block_dense.block_grams_compensated((x,), z),
                           exact, K7_ORACLE_RTOL)
    log(f"  K7 vs the f64 Gram, inputs over e^+-6: max_abs_err {err:.3e} rel "
        f"{rel:.3e} (tol {K7_ORACLE_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("K7 misses the f64 Gram on wide-range inputs")
    err, rel, ok = compare(torch, block_dense.block_grams((x,), z), exact,
                           K7_ORACLE_RTOL)
    log(f"  K3 (f32 sums) on the same inputs: max_abs_err {err:.3e} rel "
        f"{rel:.3e} ({'within' if ok else 'beyond'} the bound)")
    if ok:
        failures.append("the wide-range Gram check does not tell f32 sums "
                        "(K3) from K7's")


def record_launches(build, results, label):
    """The launch counts of the path just driven (read from 0), kept
    under the path's label."""
    launches = dict(build.LAUNCHES)
    results.setdefault("launches", {})[label] = launches
    return launches


def drive(torch, build, results, label, cfg):
    """One slice through the CLI's `run`, its launch counts read from 0."""
    from lanczos_tpu_torch.cli import run

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = run(cfg)
    torch.cuda.synchronize()
    launches = record_launches(build, results, label)
    log(f"  launches: {launches}")
    log(f"  n {out['n']} lc {out['lc']} solution {out['solution']}")
    log(f"  relative_error {out['relative_error']:.6e} (bound {REL_ERROR_BOUND:g})")
    log(f"  lanczos_seconds {out['lanczos_seconds']:.3f} (fixture + pack + "
        f"Lanczos + expm), fdtd_seconds {out['fdtd_seconds']:.3f}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out, launches


def check_slice(out, launches, want, n_solution, failures, label):
    """The launch counts `want` (name -> count) and the result's checks."""
    for name, count in want.items():
        if launches[name] != count:
            failures.append(f"{label}: {name} launched {launches[name]} "
                            f"times, expected {count}")
    sol = out["solution"]
    sol = sol if isinstance(sol, list) else [sol]
    if len(sol) != n_solution or not all(math.isfinite(x) for x in sol):
        failures.append(f"{label}: solution not finite / not of length "
                        f"{n_solution}: {sol}")
    if not out["relative_error"] < REL_ERROR_BOUND:
        failures.append(f"{label}: relative_error {out['relative_error']} "
                        f">= {REL_ERROR_BOUND}")


def fdtd_ms(torch, fdtd, op, u0, steps=50):
    """Device ms per FDTD step through the oracle's own loop."""
    return cuda_ms(torch, lambda: fdtd(op, u0, steps, 1.0), iters=1,
                   warmup=1) / steps


def block_fixture(torch):
    """The slice's operator, its start block on the card and its receiver."""
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B

    dev = torch.device("cuda")
    op = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device=dev)
    b_np = gaussian_matrix_B(N_SLICE, op.n, P_SLICE).astype("float32")
    b = op.pack(torch.from_numpy(b_np).to(dev))
    return op, b, op.trace_fn(LC)


def block_lanczos_ms(torch, op, b, tf, **kw):
    """Logs the device time of one block Lanczos + expm run (CUDA events)."""
    from lanczos_tpu_torch.methods.expm_action import block_lanczos_expm_action

    ms = cuda_ms(torch, lambda: block_lanczos_expm_action(
        op, b, M_SLICE, 1.0, 0, trace_fn=tf, **kw), iters=3, warmup=1)
    log(f"  lanczos (m={M_SLICE}) + expm: {ms:.3f} ms, "
        f"{ms / M_SLICE:.3f} ms/iteration")


def phase_block_slice(torch, build, results, failures):
    from lanczos_tpu_torch.config import LanczosConfig
    from lanczos_tpu_torch.methods.fdtd import fdtd_block

    cfg = LanczosConfig(n_grid=N_SLICE, m=M_SLICE, n_col=P_SLICE,
                        operator="pallas", fdtd_steps=FDTD_STEPS, lc=LC,
                        device="cuda")
    log(f"block slice: python -m lanczos_tpu_torch -N {N_SLICE} -m {M_SLICE} "
        f"--block --n-col {P_SLICE} --operator pallas --fdtd-steps "
        f"{FDTD_STEPS} --lc {LC}")
    out, launches = drive(torch, build, results, "block", cfg)
    # K1 in Lanczos only (v0, v1); every FDTD step is one K5
    check_slice(out, launches, {
        "apply_stencil_pair": 2, "apply_stencil_pair_gram": M_SLICE - 2,
        "fdtd_step": FDTD_STEPS, "block_grams_compensated": 0,
    }, P_SLICE, failures, "block slice")
    if launches["block_mix"] <= 0 or launches["block_grams"] <= 0:
        failures.append(f"block slice: a kernel of the path never launched: {launches}")

    # steady-state device times of the two halves, with CUDA events
    op, b, tf = block_fixture(torch)
    block_lanczos_ms(torch, op, b, tf)
    a_dt = op.scaled(torch.tensor(1.0 / FDTD_STEPS))
    u = b.clone()
    two_pass_ms = cuda_ms(torch, lambda: u.add_(a_dt.mm(u)), iters=100, warmup=5)
    log(f"  fdtd: {fdtd_ms(torch, fdtd_block, op, b):.4f} ms/step through "
        f"fdtd_block (K5), {two_pass_ms:.4f} ms/step two-pass (K1 + add)")


def phase_vector_slice(torch, build, results, failures):
    from lanczos_tpu_torch.config import LanczosConfig
    from lanczos_tpu_torch.methods.expm_action import lanczos_expm_action
    from lanczos_tpu_torch.methods.fdtd import fdtd_vector
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.models.rhs import gaussian_vector_b

    cfg = LanczosConfig(n_grid=N_SLICE, m=M_VECTOR, block=False,
                        operator="pallas", fdtd_steps=FDTD_STEPS, lc=LC,
                        device="cuda")
    log(f"vector slice: python -m lanczos_tpu_torch -N {N_SLICE} -m {M_VECTOR} "
        f"--vector --operator pallas --fdtd-steps {FDTD_STEPS} --lc {LC}")
    out, launches = drive(torch, build, results, "vector", cfg)
    for name in ("block_grams", "apply_stencil_pair", "fdtd_step", "block_mix"):
        results.setdefault("p1_launches", {})[name] = launches[name]
    # the fused route at p=1: K2 -> K1 -> K3 per step, no mono (K4)
    check_slice(out, launches, {
        "apply_stencil_pair": M_VECTOR, "block_mix": M_VECTOR,
        "block_grams": M_VECTOR + 1, "apply_stencil_pair_gram": 0,
        "fdtd_step": FDTD_STEPS, "block_grams_compensated": 0,
    }, 1, failures, "vector slice")

    dev = torch.device("cuda")
    op = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device=dev)
    b = op.pack(torch.from_numpy(
        gaussian_vector_b(N_SLICE, op.n).astype("float32")).to(dev))
    tf = op.trace_fn(LC)
    lanczos_ms = cuda_ms(torch, lambda: lanczos_expm_action(
        op, b, M_VECTOR, 1.0, 0, trace_fn=tf), iters=3, warmup=1)
    log(f"  lanczos (m={M_VECTOR}) + expm: {lanczos_ms:.3f} ms, "
        f"{lanczos_ms / M_VECTOR:.3f} ms/iteration")
    log(f"  fdtd: {fdtd_ms(torch, fdtd_vector, op, b):.4f} ms/step through "
        "fdtd_vector (K5, p=1)")


def phase_compensated_slice(torch, build, results, failures):
    from lanczos_tpu_torch.config import LanczosConfig

    cfg = LanczosConfig(n_grid=N_SLICE, m=M_SLICE, n_col=P_SLICE,
                        operator="pallas", compensated=True,
                        fdtd_steps=FDTD_STEPS, lc=LC, device="cuda")
    log(f"compensated slice: python -m lanczos_tpu_torch -N {N_SLICE} -m "
        f"{M_SLICE} --n-col {P_SLICE} --compensated --operator pallas "
        f"--fdtd-steps {FDTD_STEPS} --lc {LC}")
    out, launches = drive(torch, build, results, "compensated", cfg)
    # every Gram is K7: prologue 2, peeled step 1, m - 2 steps
    check_slice(out, launches, {
        "block_grams_compensated": M_SLICE + 1, "block_grams": 0,
        "apply_stencil_pair_gram": 0, "apply_stencil_pair": M_SLICE,
        "fdtd_step": FDTD_STEPS,
    }, P_SLICE, failures, "compensated slice")
    op, b, tf = block_fixture(torch)
    block_lanczos_ms(torch, op, b, tf, compensated=True)


# the bf16 phase: K1 at p=8 (the f32 p=4 call's bytes) and p=1, K2 and K3
# at p=1 (the fused vector route), K7 at p=4; the vector slice's Krylov
# dimension; FDTD steps at the block width, timed
P_BF16_K1, P_BF16_K7, FDTD_BF16_STEPS = 8, 4, 50
# one bf16 ulp of x is at most 2^-7 |x|: the kernel and its plain version
# both sum in f32 and round once, and FMA contraction may move the f32 sum
# across a rounding boundary; elements under 1e-6 of the largest |value|
# are held to 1e-6 of it
BF16_ULP = 2.0**-7
# bf16 against f32 (and against the plain route): 2e-2 of scale, a few bf16
# ulps (2^-8 each) of rounding carried over the first step or the 50 steps
BF16_VS_F32 = 2e-2


def within_bf16_ulp(torch, got, want):
    """(max |got - want|, ok): elementwise within one bf16 ulp of want."""
    got, want = got.float(), want.float()
    bound = torch.clamp(BF16_ULP * want.abs(), min=1e-6 * want.abs().max().item())
    diff = (got - want).abs()
    return diff.max().item(), bool((diff <= bound).all())


def lanczos_vs_f32(torch, r16, r32):
    """Per-step differences of a bf16 Lanczos run from the f32 one: T's
    entries (alphas, betas[1:]) over T's scale, betas[0] relative, the
    trace over its scale."""
    def per_step(a, b, scale):
        return ((a.float() - b).abs() / scale).reshape(a.shape[0], -1).amax(1).tolist()

    t = torch.cat([r32.alphas.flatten(), r32.betas[1:].flatten()]).abs().max()
    b0 = ((r16.betas[0].float() - r32.betas[0]).abs().max()
          / r32.betas[0].abs().max()).item()
    return (per_step(r16.alphas, r32.alphas, t),
            per_step(r16.betas[1:], r32.betas[1:], t), b0,
            per_step(r16.trace, r32.trace, r32.trace.abs().max()))


def phase_bf16(torch, build, results, failures):
    """bf16 folded-plane states (f32 weights and sums) at N=160: each bf16
    kernel against its plain version, timed beside a device copy of the
    same bytes; then the vector slice's fused route at p=1 and the FDTD
    oracle at p=4 on the bf16 operator, and a compensated block run (K7),
    each with its launch counts read from 0."""
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.methods.fdtd import fdtd_block
    from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B, gaussian_vector_b
    from lanczos_tpu_torch.ops.kernels import block_dense
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import apply_stencil_pair_plain

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    op = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, dtype=bf16, device=dev)
    op32 = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device=dev)
    if not (op.dtype == bf16 and op.wz_t.dtype == torch.float32
            and torch.equal(op.wz_t, op32.wz_t)):
        failures.append("bf16: the operator's weights are not the f32 ones")
    S = math.prod(op.state_shape)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = results.setdefault("rows", {})

    def rand(p):
        x = torch.randn((p,) + op.state_shape, generator=g, device=dev)
        return (x / x.flatten(1).norm(dim=1).view(-1, 1, 1, 1)).to(bf16)

    def record(name, key, label, err, ok, kernel_fn, plain_fn, nbytes, ops,
               ops_type="float32", library_fn=None, library_note=""):
        log(f"  {label}: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"bf16 {label} disagrees with its plain version")
        ms, plain_ms = cuda_ms(torch, kernel_fn), cuda_ms(torch, plain_fn)
        library_ms = None if library_fn is None else cuda_ms(torch, library_fn)
        src = torch.empty(nbytes // 4, dtype=torch.float16, device=dev)
        dst = torch.empty_like(src)
        copy_ms = cuda_ms(torch, lambda: dst.copy_(src))  # the same bytes
        del src, dst
        log(f"    {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, device "
            f"copy of the same {nbytes / 1e6:.1f} MB {copy_ms:.4f} ms; "
            f"{nbytes / ms / 1e6:.1f} GB/s" + library_note)
        rows.setdefault(key, kernel_row(name, err, ms, plain_ms, nbytes, ops,
                                        ops_type, library_ms, key))

    log(f"bf16 kernels vs plain at N={N_SLICE} (bf16 states, f32 weights and sums)")
    for p, key in ((P_BF16_K1, "apply_stencil_pair bf16"),
                   (1, "apply_stencil_pair bf16 p=1")):
        u = rand(p)
        plain = lambda: apply_stencil_pair_plain(  # noqa: E731
            u, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
        got = op.mm(u)
        err, ok = within_bf16_ulp(torch, got, plain())
        record("apply_stencil_pair", key, f"K1 bf16 p={p}", err,
               ok and got.dtype == bf16, lambda: op.mm(u), plain,
               2 * u.numel() * 2, 12 * p * S)
        del u, got

    # K2 and K3 at p=1: the fused vector route's calls (3 operands into a
    # new buffer; (q,), v with include_zz); one buffer holds the three, so
    # one torch.mm on the bf16 inputs is the library's (bf16 coefficients
    # and a bf16 result, where the kernels keep f32 coefficients and return
    # an f32 Gram)
    stack = rand(3)
    xs = list(stack.split(1))
    coeffs = 0.1 * torch.randn((3, 1), generator=g, device=dev)
    got = block_dense.block_mix(coeffs, xs)
    err, ok = within_bf16_ulp(torch, got, block_dense.block_mix_plain(coeffs, xs))
    c16 = coeffs.to(bf16)
    record("block_mix", "block_mix bf16 p=1", "K2 bf16 block_mix 3 operands p=1",
           err, ok and got.dtype == bf16, lambda: block_dense.block_mix(coeffs, xs),
           lambda: block_dense.block_mix_plain(coeffs, xs), 4 * S * 2, 2 * 3 * S,
           library_fn=lambda: c16.T @ stack.flatten(1),
           library_note="; library: torch.mm on bf16 (coefficients rounded "
                        "to bf16, bf16 out)")
    q, v = xs[0], xs[1]
    # K3 bf16: bf16 products are exact in f32, so it differs from its plain
    # version only by the order of the f32 sums over the state's 28M
    # elements, as f32 K3 does: the f32 Gram's KERNEL_RTOL of scale
    got = block_dense.block_grams((q,), v, include_zz=True)
    err, _, ok = compare(torch, got, block_dense.block_grams_plain(
        (q,), v, include_zz=True), KERNEL_RTOL["float32"])
    record("block_grams", "block_grams bf16 p=1",
           "K3 bf16 block_grams (q,), v, include_zz p=1", err,
           ok and got.dtype == torch.float32,
           lambda: block_dense.block_grams((q,), v, include_zz=True),
           lambda: block_dense.block_grams_plain((q,), v, include_zz=True),
           2 * S * 2, 2 * 2 * S,
           library_fn=lambda: stack[:2].flatten(1) @ v.flatten(1).T,
           library_note="; library: torch.mm on bf16 (a bf16 Gram)")
    for label, ops, zz in (("(), b, include_zz", (), True),
                           ("(x0, x1, x2), z", tuple(xs), False)):
        got = block_dense.block_grams(ops, v, include_zz=zz)
        err, _, ok = compare(torch, got, block_dense.block_grams_plain(
            ops, v, include_zz=zz), KERNEL_RTOL["float32"])
        log(f"  K3 bf16 block_grams {label} p=1: max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"bf16 K3 {label} disagrees with its plain version")
    del stack, xs, q, v, got

    # K7 at p=4: bf16 widened to f32, f64 sums, an f32 Gram
    q, v = rand(P_BF16_K7), rand(P_BF16_K7)
    got = block_dense.block_grams_compensated((q,), v, include_zz=True)
    want = block_dense.block_grams_compensated_plain((q,), v, include_zz=True)
    err, rel, ok = compare(torch, got, want, K7_RTOL)
    record("block_grams_compensated", "block_grams_compensated bf16",
           f"K7 bf16 block_grams_compensated (q,), v, include_zz p={P_BF16_K7}",
           err, ok and got.dtype == torch.float32,
           lambda: block_dense.block_grams_compensated((q,), v, include_zz=True),
           lambda: block_dense.block_grams_compensated_plain((q,), v, include_zz=True),
           2 * q.numel() * 2, 2 * (2 * P_BF16_K7) * P_BF16_K7 * S,
           ops_type="float64")
    del q, v, got, want

    # the vector slice's fused route at p=1 on the bf16 operator, from the
    # CLI's start vector, against the f32 slice
    tf = op.trace_fn(LC)
    b_np = gaussian_vector_b(N_SLICE, op.n).astype("float32")
    b32 = op32.pack(torch.from_numpy(b_np).to(dev))
    b16 = op.pack(torch.from_numpy(b_np).to(dev))
    log(f"bf16 vector slice: vector_lanczos(fused=True), N={N_SLICE}, m={M_VECTOR}")
    build.reset_launches()
    r16 = vector_lanczos(op, b16, M_VECTOR, trace_fn=tf, fused=True)
    torch.cuda.synchronize()
    launches = record_launches(build, results, "bf16 vector")
    log(f"  launches: { {k: c for k, c in launches.items() if c} }")
    for name in ("apply_stencil_pair bf16", "block_mix bf16", "block_grams bf16"):
        results.setdefault("p1_launches", {})[name] = launches[name]
    want = {"apply_stencil_pair bf16": M_VECTOR, "block_mix bf16": M_VECTOR,
            "block_grams bf16": M_VECTOR + 1}
    if {k: c for k, c in launches.items() if c} != want:
        failures.append(f"bf16 vector slice: launches {launches}, expected {want} "
                        "and nothing else (no K4, no K5, no f32 kernel)")
    r32 = vector_lanczos(op32, b32, M_VECTOR, trace_fn=tf, fused=True)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (r16.alphas, r16.betas, r16.trace))
    if not (finite and r16.alphas.dtype == bf16 and r16.trace.shape == (M_VECTOR,)):
        failures.append("bf16 vector slice: not finite / not bf16 of shape (m,)")
    d_alpha, d_beta, d_b0, d_trace = lanczos_vs_f32(torch, r16, r32)
    log(f"  vs the f32 slice, per step: |d alpha|/T {[f'{x:.2e}' for x in d_alpha]}; "
        f"|d beta_j|/T {[f'{x:.2e}' for x in d_beta]}; |d beta_0|/beta_0 {d_b0:.2e}; "
        f"|d trace|/max {[f'{x:.2e}' for x in d_trace]}")
    # held: ||b|| to one bf16 ulp, and the first step (alpha_0, beta_1,
    # trace_0) to BF16_VS_F32 of scale; later steps are logged, not held:
    # from the slice's smooth start vector each product A q amplifies the
    # states' bf16 rounding (white, 2^-9 of scale) against the smooth
    # signal, so the two runs part by tens of percent within m=8 (PERF.md)
    first = max(d_alpha[0], d_beta[0], d_trace[0])
    if not (d_b0 <= BF16_ULP and first <= BF16_VS_F32):
        failures.append(f"bf16 vector slice: beta_0 {d_b0:.2e} from f32 (bound "
                        f"{BF16_ULP:.2e}), first step {first:.2e} (bound "
                        f"{BF16_VS_F32:g})")
    # the operator itself against f32 on the slice's start vector, at JAX's
    # bound for its bf16 operator (tests/test_maxwell_pallas.py)
    y16, y32 = op.mv(b16).float(), op32.mv(b32)
    rel = ((y16 - y32).abs().max() / y32.abs().max()).item()
    log(f"  A b: bf16 operator vs f32, {rel:.3e} of scale (bound 5e-2)")
    if not rel < 5e-2:
        failures.append(f"bf16 operator: A b {rel:.3e} of scale from f32")
    del y16, y32
    ms16 = cuda_ms(torch, lambda: vector_lanczos(op, b16, M_VECTOR, trace_fn=tf,
                                                 fused=True), iters=3, warmup=1)
    ms32 = cuda_ms(torch, lambda: vector_lanczos(op32, b32, M_VECTOR, trace_fn=tf,
                                                 fused=True), iters=3, warmup=1)
    log(f"  lanczos (m={M_VECTOR}): bf16 {ms16 / M_VECTOR:.3f} ms/iteration, f32 "
        f"{ms32 / M_VECTOR:.3f}")

    # FDTD at p=4: K1 then a bf16 add each step, never K5
    B_np = gaussian_matrix_B(N_SLICE, op.n, P_SLICE).astype("float32")
    B16 = op.pack(torch.from_numpy(B_np).to(dev))
    t_end = FDTD_BF16_STEPS / FDTD_STEPS  # the CLI's dt
    log(f"bf16 FDTD: fdtd_block, p={P_SLICE}, {FDTD_BF16_STEPS} steps")
    build.reset_launches()
    u16 = fdtd_block(op, B16, FDTD_BF16_STEPS, t_end)
    torch.cuda.synchronize()
    launches = record_launches(build, results, "bf16 fdtd")
    log(f"  launches: { {k: c for k, c in launches.items() if c} }")
    if {k: c for k, c in launches.items() if c} != {
            "apply_stencil_pair bf16": FDTD_BF16_STEPS}:
        failures.append(f"bf16 FDTD: launches {launches}, expected K1 bf16 "
                        f"{FDTD_BF16_STEPS} times and no K5")
    # the plain route: the same loop with K1's plain version
    a_dt = op.scaled(torch.tensor(t_end / FDTD_BF16_STEPS, dtype=bf16))
    plain = B16
    for _ in range(FDTD_BF16_STEPS):
        plain = plain + apply_stencil_pair_plain(plain, a_dt.wz_t, a_dt.wplane_s,
                                                 a_dt.spec_e, a_dt.spec_h)
    err, rel, ok = compare(torch, u16, plain, BF16_VS_F32)
    log(f"  vs the plain route: max_abs_err {err:.3e} rel {rel:.3e} "
        f"(tol {BF16_VS_F32:g}) {'ok' if ok else 'FAIL'}")
    if not (ok and u16.dtype == bf16):
        failures.append("bf16 FDTD disagrees with its plain route")
    step16 = fdtd_ms(torch, fdtd_block, op, B16, FDTD_BF16_STEPS)
    step32 = fdtd_ms(torch, fdtd_block, op32, op32.pack(torch.from_numpy(B_np).to(dev)),
                     FDTD_BF16_STEPS)
    log(f"  fdtd: bf16 {step16:.4f} ms/step (K1 + add), f32 {step32:.4f} "
        f"ms/step (K5), p={P_SLICE}")
    del u16, plain, a_dt

    # K7 on a main path: block Lanczos with compensated Grams on the bf16
    # operator (the 3-call fused step: K2, K1, K7; JAX's runs too)
    log(f"bf16 compensated block run: block_lanczos(compensated=True), "
        f"p={P_SLICE}, m={M_SLICE}")
    op_tf = op.trace_fn(LC)
    build.reset_launches()
    rb = block_lanczos(op, B16, M_SLICE, trace_fn=op_tf, compensated=True)
    torch.cuda.synchronize()
    launches = record_launches(build, results, "bf16 compensated")
    log(f"  launches: { {k: c for k, c in launches.items() if c} }")
    want = {"block_grams_compensated bf16": M_SLICE + 1,
            "apply_stencil_pair bf16": M_SLICE, "block_mix bf16": M_SLICE}
    if {k: c for k, c in launches.items() if c} != want:
        failures.append(f"bf16 compensated run: launches {launches}, expected {want}")
    if not all(bool(torch.isfinite(t.float()).all())
               for t in (rb.alphas, rb.betas, rb.trace)):
        failures.append("bf16 compensated run: not finite")
    rb32 = block_lanczos(op32, op32.pack(torch.from_numpy(B_np).to(dev)), M_SLICE,
                         trace_fn=op_tf, compensated=True)
    d_alpha, d_beta, d_b0, d_trace = lanczos_vs_f32(torch, rb, rb32)
    log(f"  vs f32, per step: |d alpha|/T {[f'{x:.2e}' for x in d_alpha]}; "
        f"|d beta_j|/T {[f'{x:.2e}' for x in d_beta]}; |d beta_0| {d_b0:.2e}; "
        f"|d trace|/max {[f'{x:.2e}' for x in d_trace]}")


def small_windowed_cases():
    """Odd geometries for K8: rectangular, unstructured (several windows a
    chunk and the greedy packing), an RCM-permuted band, 997 rows."""
    import numpy as np
    import scipy.sparse as sp

    def band(n, k):
        return sp.diags([np.full(n - abs(o), 2.0 if o == 0 else -1.0)
                         for o in range(-k, k + 1)], list(range(-k, k + 1)),
                        format="csr")

    perm = np.random.default_rng(5).permutation(1500)
    return {
        "300x900 random": (sp.random(300, 900, density=0.01, random_state=3,
                                     format="csr"), {}),
        "500x500 unstructured": (sp.random(500, 500, density=0.02,
                                           random_state=2, format="csr"), {}),
        "RCM-permuted band": (band(1500, 3)[perm][:, perm].tocsr(),
                              dict(reorder="rcm")),
        "997-row band": (band(999, 1)[:997, :999].tocsr(), {}),
    }


def phase_native(torch, failures, assembled):
    """The 10.5M-row synthetic matrix planned by the C++ engine and by its
    NumPy version: the plans must be bit-equal; the native one stays in
    `assembled` for the K8 and assembled-slice phases."""
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    a = synth_suitesparse_banded(N_ASSEMBLED)
    log(f"native: assembled matrix {a.shape[0]} rows, {a.nnz} nnz, "
        f"{time.perf_counter() - t0:.2f} s on the host")
    plans = {}
    for packer in ("native", "numpy"):
        t0 = time.perf_counter()
        plans[packer] = windowed_from_scipy(a, reorder="none", device=dev,
                                            packer=packer)
        torch.cuda.synchronize()
        log(f"  plan, {packer} packer: {time.perf_counter() - t0:.2f} s")
    A, B = plans["native"], plans["numpy"]
    log(f"  ppc {A.ppc}, wsz {A.wsz}, ng {A.ng}, n128 {A.n128}, "
        f"{A.device_bytes() / 1e6:.1f} MB on the device")
    names = ("planes_data", "planes_lidx", "planes_off", "wb", "perm")
    same = {n: torch.equal(getattr(A, n), getattr(B, n)) for n in names}
    same["geometry"] = (A.ppc, A.wsz, A.n128) == (B.ppc, B.wsz, B.n128)
    log(f"  native plan bit-equal to the NumPy plan: {same}")
    if not all(same.values()):
        failures.append(f"native: the two plans differ: {same}")
    del plans, B
    torch.cuda.empty_cache()
    assembled.update(a=a, A=A)


def phase_windowed_kernel(torch, results, failures, assembled):
    """K8 against its plain version at small odd geometries (p=3 and p=1,
    f32 and f64), then at the assembled slice's shape, p=8 and p=1, timed
    against plain, a device copy of the state and cuSPARSE; at p=8 also
    against scipy's f64 product.  Leaves the 10.5M-row matrix and its plan
    in `assembled` for the slice phase; the matrix and its native plan
    come from the native phase."""
    import numpy as np

    from lanczos_tpu_torch.ops.kernels.window_ell import (
        windowed_spmm,
        windowed_spmm_plain,
    )
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def check(label, dname, got, want):
        err, rel, ok = compare(torch, got, want, KERNEL_RTOL[dname])
        log(f"  {label}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {KERNEL_RTOL[dname]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} disagrees with its plain version")
        return err

    log("K8 windowed_spmm vs plain at small geometries, p=3 and p=1")
    for label, (a, kw) in small_windowed_cases().items():
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            A = windowed_from_scipy(a, dtype=dtype, ppc_cap=256, device=dev, **kw)
            for p in (3, 1):
                X = A.pack(torch.from_numpy(
                    rng.standard_normal((p, a.shape[1]))).to(dev, dtype))
                check(f"K8 {label} {dname} p={p} (ppc {A.ppc})", dname,
                      windowed_spmm(A, X), windowed_spmm_plain(A, X))

    a, A = assembled["a"], assembled["A"]  # the native phase's plan

    # cuSPARSE's SpMM on the same matrix, the library yardstick (not used
    # anywhere in the port)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr).to(dev), torch.from_numpy(a.indices).to(dev),
        torch.from_numpy(a.data).to(dev), size=a.shape)
    plane_bytes = sum(t.numel() * t.element_size()
                      for t in (A.planes_data, A.planes_lidx, A.planes_off, A.wb))
    n = a.shape[0]
    for p in (P_ASSEMBLED, 1):
        log(f"K8 at the assembled slice's shape, p={p}")
        X = A.pack(torch.from_numpy(
            rng.standard_normal((p, n)).astype(np.float32)).to(dev))
        out = torch.empty_like(X)
        got = windowed_spmm(A, X, out).clone()
        err = check(f"K8 {n} rows p={p}", "float32", got,
                    windowed_spmm_plain(A, X))
        if p == P_ASSEMBLED:
            ref = np.asarray(a.astype(np.float64) @ X[:, :n].cpu().numpy().T.astype(np.float64)).T
            err_s, rel_s, ok = compare(torch, got[:, :n].cpu(), torch.from_numpy(ref),
                                       K8_SCIPY_RTOL)
            log(f"  K8 vs scipy's f64 product: max_abs_err {err_s:.3e} rel "
                f"{rel_s:.3e} (tol {K8_SCIPY_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("K8 misses scipy's f64 product at p=8")
            del ref
        ms = cuda_ms(torch, lambda: windowed_spmm(A, X, out))
        plain_ms = cuda_ms(torch, lambda: windowed_spmm_plain(A, X))
        copy_ms = cuda_ms(torch, lambda: out.copy_(X))
        # cuSPARSE with B row-major (an (n, p) copy) and column-major (the
        # state's own buffer, a transposed view); the faster is library_ms
        lib_ms = {}
        for layout, xt in (("row-major", X[:, :n].T.contiguous()),
                           ("column-major", X[:, :n].T)):
            lib = torch.sparse.mm(csr, xt)
            _, lib_rel, _ = compare(torch, lib.T, got[:, :n], 1.0)
            lib_ms[layout] = cuda_ms(torch, lambda: torch.sparse.mm(csr, xt))
            log(f"  cuSPARSE, B {layout}: {lib_ms[layout]:.4f} ms (agrees to "
                f"{lib_rel:.1e} of scale)")
            del lib, xt
        library_ms = min(lib_ms.values())
        nbytes = plane_bytes + 2 * X.numel() * X.element_size()
        log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuSPARSE "
            f"{library_ms:.4f} ms (the faster layout), copy of "
            f"the state {copy_ms:.4f} ms ({2 * X.numel() * 4 / copy_ms / 1e6:.1f} "
            f"GB/s); {nbytes / 1e6:.1f} MB/call -> {nbytes / ms / 1e6:.1f} GB/s, "
            f"{a.nnz * p / (ms * 1e-3):.4e} nnz*col/s")
        key = "windowed_spmm" if p == P_ASSEMBLED else "windowed_spmm p=1"
        row = kernel_row("windowed_spmm", err, ms, plain_ms, nbytes,
                         2 * a.nnz * p, "float32", library_ms, key)
        results.setdefault("rows", {})[key] = row
        if p == P_ASSEMBLED:
            assembled["spmm_ms"] = ms
        del X, out, got
    del csr
    torch.cuda.empty_cache()


def assembled_eigsh(torch, A, seed=0, compute_vectors=True):
    """block_lanczos_eigsh on the padded windowed operator, as the JAX
    benchmark runs it (benchmarks/suitesparse_scale.py:218-220)."""
    import numpy as np

    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh
    from lanczos_tpu_torch.ops.window_ell import PaddedWindowedOperator

    op = PaddedWindowedOperator(A)
    x = np.random.default_rng(seed).standard_normal(
        (P_ASSEMBLED, A.n_rows_true)).astype(np.float32)
    b = A.pack(torch.from_numpy(x).cuda())
    vals, vecs, bounds = block_lanczos_eigsh(
        op, b, M_ASSEMBLED, K_ASSEMBLED, which="LA", reorth="full",
        normalize="qr", breakdown_eps=1e-4, replace_dead=True,
        eig_backend="newton", compute_vectors=compute_vectors)
    return op, vals, vecs, bounds


def phase_assembled_slice(torch, build, results, failures, assembled):
    import numpy as np

    from lanczos_tpu_torch.methods.eigs import ritz_residuals

    A = assembled["A"]
    log(f"assembled slice: block_lanczos_eigsh p={P_ASSEMBLED} m={M_ASSEMBLED} "
        f"k={K_ASSEMBLED} reorth=full normalize=qr breakdown_eps=1e-4 "
        f"replace_dead on {A.n_rows_true} rows, then ritz_residuals")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    op, vals, vecs, bounds = assembled_eigsh(torch, A)
    torch.cuda.synchronize()
    lanczos_s = time.perf_counter() - t0
    in_recurrence = build.LAUNCHES["windowed_spmm"]
    resid = ritz_residuals(op, vals, vecs)
    torch.cuda.synchronize()
    launches = record_launches(build, results, "assembled")
    vals_h, resid_h = vals.cpu().numpy(), resid.cpu().numpy()
    log(f"  launches: {launches} ({in_recurrence} in the recurrence)")
    log(f"  Ritz values {vals_h.tolist()}")
    log(f"  measured residuals {resid_h.tolist()} (bound {RESID_BOUND:g}); "
        f"|beta_m S| bounds {bounds.cpu().numpy().tolist()}")
    spmm_ms = assembled["spmm_ms"]
    log(f"  SpMM {spmm_ms:.4f} ms at p={P_ASSEMBLED}, "
        f"{A.nnz * P_ASSEMBLED / (spmm_ms * 1e-3):.4e} nnz*col/s; Lanczos + eigsh "
        f"{lanczos_s:.3f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if in_recurrence != M_ASSEMBLED or launches["windowed_spmm"] != M_ASSEMBLED + 1:
        failures.append(f"assembled slice: K8 launched {in_recurrence} times in "
                        f"the recurrence and {launches['windowed_spmm']} in all, "
                        f"expected {M_ASSEMBLED} and {M_ASSEMBLED + 1}")
    if any(c for k, c in launches.items() if k != "windowed_spmm"):
        failures.append(f"assembled slice: another kernel launched: {launches}")
    if not (np.all(np.isfinite(vals_h)) and np.all(resid_h < RESID_BOUND)):
        failures.append(f"assembled slice: Ritz values {vals_h} / residuals "
                        f"{resid_h} not finite or not under {RESID_BOUND}")
    del vals, vecs, bounds, resid
    assembled_vector(torch, build, results, failures, op)
    del op
    # the multidevice ell phase holds its shards to this plan's K8 product
    # and its Ritz values to these, then frees the matrix and the plan
    assembled["ritz"] = vals_h
    torch.cuda.empty_cache()
    assembled_small(torch, build, results, failures)


def assembled_vector(torch, build, results, failures, op):
    """The assembled slice's operator through single-vector Lanczos:
    `lanczos_eigsh` (p=1, m=96, k=5, reorth full, compute_vectors), then
    `ritz_residuals`.  Every product of the recurrence is K8 at p=1; the
    residuals' k=5 block is one more launch."""
    import numpy as np

    from lanczos_tpu_torch.methods.eigs import lanczos_eigsh, ritz_residuals

    A = op.base
    log(f"assembled vector slice: lanczos_eigsh p=1 m={M_VECTOR_EIGSH} "
        f"k={K_ASSEMBLED} reorth=full on {A.n_rows_true} rows, then "
        f"ritz_residuals")
    x = np.random.default_rng(1).standard_normal(A.n_rows_true).astype(np.float32)
    b = A.pack(torch.from_numpy(x).cuda())[0]
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    vals, vecs, bounds = lanczos_eigsh(op, b, M_VECTOR_EIGSH, K_ASSEMBLED,
                                       which="LA", reorth="full",
                                       compute_vectors=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    in_recurrence = build.LAUNCHES["windowed_spmm"]
    results.setdefault("p1_launches", {})["windowed_spmm"] = in_recurrence
    resid = ritz_residuals(op, vals, vecs)
    torch.cuda.synchronize()
    launches = record_launches(build, results, "assembled vector")
    vals_h, resid_h = vals.cpu().numpy(), resid.cpu().numpy()
    log(f"  launches: {launches} ({in_recurrence} in the recurrence); "
        f"Lanczos + eigsh {wall_s:.3f} s wall")
    log(f"  Ritz values {vals_h.tolist()}")
    log(f"  measured residuals {resid_h.tolist()} (bound {RESID_BOUND:g}); "
        f"|beta_m s| bounds {bounds.cpu().numpy().tolist()}")
    if in_recurrence != M_VECTOR_EIGSH or launches["windowed_spmm"] != M_VECTOR_EIGSH + 1:
        failures.append(f"assembled vector slice: K8 launched {in_recurrence} "
                        f"times in the recurrence and {launches['windowed_spmm']} "
                        f"in all, expected {M_VECTOR_EIGSH} and {M_VECTOR_EIGSH + 1}")
    if any(c for k, c in launches.items() if k != "windowed_spmm"):
        failures.append(f"assembled vector slice: another kernel launched: {launches}")
    if not (np.all(np.isfinite(vals_h)) and np.all(resid_h < RESID_BOUND)):
        failures.append(f"assembled vector slice: Ritz values {vals_h} / "
                        f"residuals {resid_h} not finite or not under {RESID_BOUND}")


def assembled_small(torch, build, results, failures):
    """The assembled slice at 262,144 rows against scipy's eigsh, and a
    .mtx round trip of a slab through operator_from_file."""
    import tempfile

    import numpy as np
    from scipy.io import mmwrite
    from scipy.sparse.linalg import eigsh

    from lanczos_tpu_torch.io import operator_from_file
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    a = synth_suitesparse_banded(N_ASSEMBLED_SMALL)
    log(f"assembled slice at {N_ASSEMBLED_SMALL} rows against scipy eigsh")
    A = windowed_from_scipy(a, reorder="none", device="cuda")
    build.reset_launches()
    _, vals, _, _ = assembled_eigsh(torch, A, compute_vectors=False)
    torch.cuda.synchronize()
    launches = record_launches(build, results, "assembled 262144")
    got = vals.cpu().numpy().astype(np.float64)
    want = np.sort(eigsh(a.astype(np.float64), k=K_ASSEMBLED, which="LA")[0])[::-1]
    rel = np.abs(got - want) / np.abs(want)
    log(f"  launches {launches}; Ritz {got.tolist()}; scipy {want.tolist()}; "
        f"rel {rel.max():.2e} (tol {EIGSH_RTOL:g})")
    if launches["windowed_spmm"] != M_ASSEMBLED or not rel.max() <= EIGSH_RTOL:
        failures.append(f"assembled slice at {N_ASSEMBLED_SMALL} rows: K8 "
                        f"{launches['windowed_spmm']} launches, top-5 rel {rel}")

    slab = a[:2000, :2000].tocoo()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slab.mtx")
        mmwrite(path, slab)
        W = operator_from_file(path, format="windowed", device="cuda")
    x = np.random.default_rng(1).standard_normal((3, 2000))
    y = W.unpermute(W.mm(W.permute(torch.from_numpy(x).float().cuda())))
    err, rel, ok = compare(torch, y.cpu(), torch.from_numpy((slab @ x.T).T),
                           K8_SCIPY_RTOL)
    log(f"  .mtx round trip through operator_from_file(format='windowed'): "
        f"{type(W).__name__} ppc {W.ppc}, vs scipy rel {rel:.2e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("the .mtx round trip disagrees with scipy")


def phase_ell_slice(torch, build, results, failures):
    from lanczos_tpu_torch.config import LanczosConfig
    from lanczos_tpu_torch.models.maxwell import maxwell_ell_operator
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ell = maxwell_ell_operator(N_ELL, N_ELL, N_ELL, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in (ell.data, ell.indices))
    log(f"ELL operator at N={N_ELL}: {ell.shape[0]} rows, built by the native "
        f"engine in {time.perf_counter() - t0:.2f} s, {nbytes / 1e6:.1f} MB "
        "of values and indices")
    op = PallasMaxwellOperator.create(N_ELL, N_ELL, N_ELL, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((P_SLICE, op.n), generator=g, device=dev)
    u = op.pack(x)
    got, want = ell.mm(x), op.unpack(op.mm(u))
    err, rel, ok = compare(torch, got, want, ELL_VS_K1_RTOL)
    log(f"  ELL A X vs K1's A X at p={P_SLICE}: max_abs_err {err:.3e} rel "
        f"{rel:.3e} (tol {ELL_VS_K1_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("the N=160 ELL operator disagrees with K1")
    ell_ms = cuda_ms(torch, lambda: ell.mm(x))
    k1_ms = cuda_ms(torch, lambda: op.mm(u))
    log(f"  A X at p={P_SLICE}: gathered ELL (plain torch) {ell_ms:.4f} ms, "
        f"{4 * ell.shape[0] * P_SLICE / (ell_ms * 1e-3):.4e} nnz*col/s; K1 "
        f"{k1_ms:.4f} ms, {4 * op.n * P_SLICE / (k1_ms * 1e-3):.4e} nnz*col/s")
    del ell, op, x, u, got, want
    torch.cuda.empty_cache()

    cfg = LanczosConfig(n_grid=N_ELL, m=M_ELL, n_col=P_SLICE, operator="ell",
                        fdtd_steps=FDTD_STEPS, lc=LC, device="cuda")
    log(f"ELL slice: python -m lanczos_tpu_torch -N {N_ELL} -m {M_ELL} "
        f"--n-col {P_SLICE} --operator ell --fdtd-steps {FDTD_STEPS} --lc {LC}")
    out, launches = drive(torch, build, results, "ell", cfg)
    # gathered ELL is plain torch, as it is XLA in the JAX package; the
    # fused recurrence's block_mix and Grams are K2/K3: one K2 a step, one
    # K3 a step plus the start block's
    want = {k: 0 for k in launches}
    want.update(block_mix=M_ELL, block_grams=M_ELL + 1)
    check_slice(out, launches, want, P_SLICE, failures, "ELL slice")


@contextlib.contextmanager
def patched(module, name, value):
    """module.name replaced by value inside the block."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


class StopAfterFirstChunk(Exception):
    """Stands in for a job killed between two checkpointed chunks."""


def phase_unpaired_pair(torch, build, results, failures):
    """A U at N=160 p=4 through apply_stencil_pair with both halves
    unpaired: two K6 launches and no K1, against K1's paired A U."""
    import dataclasses

    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import apply_stencil_pair

    dev = torch.device("cuda")
    op = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    u = op.pack(torch.randn((P_SLICE, op.n), generator=g, device=dev))
    loose = [dataclasses.replace(s, paired=False) for s in (op.spec_e, op.spec_h)]
    log(f"unpaired pair: apply_stencil_pair at N={N_SLICE} p={P_SLICE}, "
        "paired=False on both halves")
    build.reset_launches()
    got = apply_stencil_pair(u, op.wz_t, op.wplane_s, *loose)
    torch.cuda.synchronize()
    launches = record_launches(build, results, "unpaired pair")
    log(f"  launches: {launches}")
    want = {k: 0 for k in launches} | {"apply_stencil": 2}
    if launches != want:
        failures.append(f"unpaired pair: launches {launches}, expected {want}")
    err, rel, ok = compare(torch, got, op.mm(u), UNPAIRED_RTOL)
    log(f"  vs K1's paired A U: max_abs_err {err:.3e} rel {rel:.3e} (tol "
        f"{UNPAIRED_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("the unpaired pair via K6 disagrees with K1's A U")
    k6_ms = cuda_ms(torch, lambda: apply_stencil_pair(u, op.wz_t, op.wplane_s, *loose))
    k1_ms = cuda_ms(torch, lambda: op.mm(u))
    log(f"  A U: unpaired via K6 (2 launches) {k6_ms:.4f} ms, paired K1 "
        f"{k1_ms:.4f} ms")
    unpaired_k4_k5(torch, build, op, u, loose, failures)


def unpaired_k4_k5(torch, build, op, u, loose, failures):
    """K5 and K4 with both halves unpaired at N=160 p=4, each against its
    plain version, each one launch of its own kernel."""
    from lanczos_tpu_torch.ops.kernels import stencil_fdtd, stencil_gram

    a_dt = op.scaled(1.0 / FDTD_STEPS)
    checks = {}
    build.reset_launches()
    got = stencil_fdtd.fdtd_step(u, torch.empty_like(u), a_dt.wz_t,
                                 a_dt.wplane_s, *loose)
    torch.cuda.synchronize()
    checks["K5 unpaired"] = (dict(build.LAUNCHES), {"fdtd_step": 1}, got,
                             stencil_fdtd.fdtd_step_plain(
                                 u, torch.empty_like(u), a_dt.wz_t,
                                 a_dt.wplane_s, *loose))
    dst = torch.randn_like(u)
    want_v, want_g3 = stencil_gram.apply_stencil_pair_gram_plain(
        u, dst.clone(), op.wz_t, op.wplane_s, *loose)
    build.reset_launches()
    v, g3 = stencil_gram.apply_stencil_pair_gram(u, dst, op.wz_t, op.wplane_s,
                                                 *loose)
    torch.cuda.synchronize()
    k4_launches = dict(build.LAUNCHES)
    checks["K4 unpaired v"] = (k4_launches, {"apply_stencil_pair_gram": 1},
                               v, want_v)
    checks["K4 unpaired g3"] = (k4_launches, {"apply_stencil_pair_gram": 1},
                                g3, want_g3)
    for label, (launches, want_launches, got, want) in checks.items():
        err, rel, ok = compare(torch, got, want, KERNEL_RTOL["float32"])
        nonzero = {k: c for k, c in launches.items() if c}
        log(f"  {label} vs plain: max_abs_err {err:.3e} rel {rel:.3e} (tol "
            f"{KERNEL_RTOL['float32']:.0e}) {'ok' if ok else 'FAIL'}; launches "
            f"{nonzero}")
        if not ok or nonzero != want_launches:
            failures.append(f"{label}: rel {rel:.3e}, launches {nonzero}, "
                            f"expected {want_launches}")


def phase_checkpoint(torch, build, results, failures):
    """Checkpointed block Lanczos and FDTD at N=160 p=4 (the block slice's
    operator and start block), files in a temporary directory: the chunked
    run against block_lanczos(fused=False); a run stopped at j=4 (an m=4
    run's file, grown) and resumed to m=6 against the uninterrupted chunked
    run, bit for bit; FDTD stopped after its first chunk and resumed,
    against fdtd_block, bit for bit.  The references run first, so the
    launch counts are the checkpointed runs' own."""
    import tempfile

    import numpy as np

    from lanczos_tpu_torch.methods import checkpoint as ck
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.methods.fdtd import fdtd_block

    op, b, tf = block_fixture(torch)
    m, chunk = M_CHECKPOINT, CHUNK_CHECKPOINT
    log(f"checkpoint: N={N_SLICE} p={P_SLICE} m={m} chunk={chunk}; FDTD "
        f"{FDTD_STEPS} steps in chunks of {FDTD_STEPS // 2}")
    ref = block_lanczos(op, b, m, 0, trace_fn=tf, fused=False)
    ref_u = fdtd_block(op, b, FDTD_STEPS, 1.0).clone()
    torch.cuda.synchronize()

    saves = []
    real_save = ck._atomic_savez

    def timed_save(path, **arrays):
        t0 = time.perf_counter()
        real_save(path, **arrays)
        saves.append(time.perf_counter() - t0)
        log(f"  save {os.path.basename(path)}: {saves[-1]:.3f} s, "
            f"{os.path.getsize(path) / 1e6:.1f} MB")

    def stop_after_first(real):
        def once(*args, **kw):
            if stop_after_first.calls:
                raise StopAfterFirstChunk
            stop_after_first.calls += 1
            return real(*args, **kw)
        stop_after_first.calls = 0
        return once

    with tempfile.TemporaryDirectory() as tmp, patched(ck, "_atomic_savez", timed_save):
        whole, part, fd = (os.path.join(tmp, f) for f in ("whole.npz", "part.npz",
                                                           "fdtd.npz"))
        build.reset_launches()
        got = ck.block_lanczos_checkpointed(op, b, m, 0, chunk=chunk, path=whole,
                                            trace_fn=tf)
        ck.block_lanczos_checkpointed(op, b, M_STOPPED, 0, chunk=chunk, path=part,
                                      trace_fn=tf)
        stopped = ck.BlockLanczosCheckpoint.load(part)
        for name in ("alphas", "betas", "trace"):
            arr = getattr(stopped, name)
            grown = np.zeros((m,) + arr.shape[1:], arr.dtype)
            grown[: arr.shape[0]] = arr
            setattr(stopped, name, grown)
        stopped.m = m
        stopped.save(part)
        resumed = ck.block_lanczos_checkpointed(op, b, m, 0, chunk=chunk, path=part,
                                                trace_fn=tf)
        with patched(ck, "euler_steps", stop_after_first(ck.euler_steps)):
            try:
                ck.fdtd_checkpointed(op, b, FDTD_STEPS, 1.0, chunk=FDTD_STEPS // 2,
                                     path=fd, block=True)
                failures.append("checkpoint: the FDTD run did not stop")
            except StopAfterFirstChunk:
                pass
        with np.load(fd) as z:
            stopped_at = int(z["step"])
        u = ck.fdtd_checkpointed(op, b, FDTD_STEPS, 1.0, chunk=FDTD_STEPS // 2,
                                 path=fd, block=True)
        torch.cuda.synchronize()
        launches = record_launches(build, results, "checkpoint")
        log(f"  launches: {launches}; FDTD stopped at step {stopped_at}")
        w_equal = np.array_equal(ck.BlockLanczosCheckpoint.load(part).w,
                                 ck.BlockLanczosCheckpoint.load(whole).w)

    for name in ("alphas", "betas", "trace"):
        err, rel, ok = compare(torch, getattr(got, name), getattr(ref, name),
                               KERNEL_RTOL["float32"])
        log(f"  chunked {name} vs block_lanczos(fused=False): rel {rel:.3e} "
            f"(tol {KERNEL_RTOL['float32']:.0e}), bit-equal "
            f"{torch.equal(getattr(got, name), getattr(ref, name))}")
        if not ok:
            failures.append(f"checkpoint: chunked {name} misses block_lanczos")
    same = {n: torch.equal(getattr(resumed, n), getattr(got, n))
            for n in ("alphas", "betas", "trace")}
    same["w"] = w_equal
    same["fdtd u"] = torch.equal(u, ref_u)
    log(f"  resumed == uninterrupted, bit for bit: {same}")
    if not all(same.values()):
        failures.append(f"checkpoint: a resumed run differs: {same}")
    want = {"apply_stencil_pair": m + M_STOPPED + (m - M_STOPPED),
            "fdtd_step": FDTD_STEPS}
    if stopped_at != FDTD_STEPS // 2 or any(launches[k] != v for k, v in want.items()):
        failures.append(f"checkpoint: launches {launches} / stop {stopped_at}, "
                        f"expected {want} / {FDTD_STEPS // 2}")
    log(f"  {len(saves)} saves, {sum(saves):.3f} s in all")


def phase_profile(torch, build, results, failures):
    """The block slice's Lanczos once more through `run`, with --profile
    and --no-validate: the trace exists and names K4's kernel, and the
    launch counts are the block slice's without its FDTD."""
    import tempfile

    from lanczos_tpu_torch.cli import TRACE_FILE, run
    from lanczos_tpu_torch.config import LanczosConfig

    with tempfile.TemporaryDirectory() as tmp:
        cfg = LanczosConfig(n_grid=N_SLICE, m=M_SLICE, n_col=P_SLICE,
                            operator="pallas", lc=LC, validate=False,
                            profile_dir=tmp, device="cuda")
        log(f"profile: python -m lanczos_tpu_torch -N {N_SLICE} -m {M_SLICE} "
            f"--n-col {P_SLICE} --operator pallas --lc {LC} --no-validate "
            f"--profile DIR")
        build.reset_launches()
        out = run(cfg)
        torch.cuda.synchronize()
        launches = record_launches(build, results, "profile")
        path = os.path.join(tmp, TRACE_FILE)
        with open(path) as f:
            trace = json.load(f)
        size = os.path.getsize(path)
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    # the repo's kernels live in the .cu's anonymous namespace
    ours = {}
    for e in kernels:
        m = re.search(r"\(anonymous namespace\)::(\w+_kernel)<", e["name"])
        if m:
            n, us = ours.get(m.group(1), (0, 0.0))
            ours[m.group(1)] = (n + 1, us + e.get("dur", 0))
    log(f"  launches: {launches}; lanczos_seconds {out['lanczos_seconds']:.3f}; "
        f"trace {size / 1e6:.1f} MB, {len(kernels)} kernel events, "
        f"{sum(e.get('dur', 0) for e in kernels) / 1e3:.3f} ms of kernels; "
        "the repo's (events, ms): "
        + ", ".join(f"{k} {n} {us / 1e3:.3f}" for k, (n, us) in sorted(ours.items())))
    if out.get("profile_dir") != tmp:
        failures.append("profile: the result does not name its directory")
    if "stencil_gram_kernel" not in ours:
        failures.append("profile: the trace names no stencil_gram_kernel")
    block = results.get("launches", {}).get("block")
    want = block and {k: v for k, v in block.items() if k != "fdtd_step"} | {"fdtd_step": 0}
    if launches != want:
        failures.append(f"profile: launches {launches}, the block slice's "
                        f"without FDTD are {want}")


def phase_bench(torch, build, results, failures):
    """The headline bench's measurement on the card, its JSON line, and K1
    timed three ways: the bench's slope, `benchmark_chained` (CUDA events
    around chains of 20) and `cuda_ms` (the mean of 20 calls on one
    input, phase 3's protocol)."""
    from lanczos_tpu_torch import bench
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.utils.timing import benchmark_chained

    log(f"bench: python -m lanczos_tpu_torch.bench (N={bench.N_GRID}, p={bench.P})")
    build.reset_launches()
    out = bench.measure()
    torch.cuda.synchronize()
    launches = record_launches(build, results, "bench")
    log(json.dumps({k: out[k] for k in ("metric", "value", "unit", "vs_baseline")}))
    log(f"  launches: {launches}")
    if launches["apply_stencil_pair"] <= 0 or any(
            c for k, c in launches.items() if k != "apply_stencil_pair"):
        failures.append(f"bench: launches {launches}, expected K1 only")

    op = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device="cuda")
    damped = op.scaled(1e-2)
    g = torch.Generator(device="cuda").manual_seed(0)
    u = damped.pack(torch.randn((P_SLICE, op.n), generator=g, device="cuda"))
    chained_ms = benchmark_chained(lambda y, a: a.mm(y), u, damped, reps=20) * 1e3
    mean_ms = cuda_ms(torch, lambda: damped.mm(u))
    slope_ms = out["seconds"] * 1e3
    k1_ms = results["rows"]["apply_stencil_pair"]["ms"]
    rel = abs(slope_ms - k1_ms) / k1_ms
    log(f"  K1 at N={N_SLICE} p={P_SLICE}, ms a call: slope (bench, best of "
        f"{bench.SLOPES}) {slope_ms:.4f}; benchmark_chained (best of 5 chains "
        f"of 20) {chained_ms:.4f}; mean of {TIMED_LAUNCHES} calls on one input "
        f"{mean_ms:.4f} (phase 3: {k1_ms:.4f}); the bench vs phase 3 "
        f"{rel:.2%} (tol {BENCH_RTOL:.0%})")
    if not rel <= BENCH_RTOL:
        failures.append(f"bench: {slope_ms:.4f} ms a call against K1's "
                        f"{k1_ms:.4f} ms in the kernels phase")


def run_driver(torch, build, results, name, argv):
    """One benchmark driver's main, its launch counts read from 0."""
    import importlib

    module = importlib.import_module(f"lanczos_tpu_torch.benchmarks.{name}")
    log(f"driver: python -m lanczos_tpu_torch.benchmarks.{name} {' '.join(argv)}")
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        out = module.main(argv)
    except SystemExit as e:  # the drivers' roofline guards exit
        raise RuntimeError(f"{name} exited: {e}") from None
    torch.cuda.synchronize()
    launches = record_launches(build, results, f"driver {name}")
    log(f"  [{name}: {time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: c for k, c in launches.items() if c} }]")
    return out, launches


def phase_drivers(torch, build, results, failures):
    """Each benchmark driver once at a cut size, with its own checks."""
    kb, launches = run_driver(torch, build, results, "kernel_bench", [
        "--only", "copy_bw,spmm_stencil,spmm_stencil_bf16,block_mix,block_grams",
        "--rows", "4000000", "--grid", "96", "--rows-copy", "8000000"])
    for name in ("apply_stencil_pair", "block_mix", "block_grams",
                 "apply_stencil_pair bf16"):
        if launches[name] <= 0:
            failures.append(f"kernel_bench: {name} never launched")
    if set(kb) != {"copy_bw", "spmm_stencil", "spmm_stencil_bf16", "block_mix",
                   "block_grams"}:
        failures.append(f"kernel_bench: campaigns {sorted(kb)}")

    rows, launches = run_driver(torch, build, results, "sweep_lanczos", [
        "--n-col", "4", "--n-min", "64", "--n-max", "80"])
    if [r["n_grid"] for r in rows] != [64, 80] or any(
            r["route"] != "mono" for r in rows) or launches["apply_stencil_pair_gram"] <= 0:
        failures.append(f"sweep_lanczos: rows {rows}, launches {launches}")

    rows, launches = run_driver(torch, build, results, "convergence", [
        "--m-max", str(DRIVER_CONVERGENCE_M),
        "--fdtd-steps", str(DRIVER_CONVERGENCE_STEPS)])
    plateau = [r["rel_error"] for r in rows if r["m"] >= 5]
    log(f"  convergence at m >= 5: {plateau} (bound {DRIVER_CONVERGENCE_BOUND:g} "
        f"at {DRIVER_CONVERGENCE_STEPS} steps)")
    if (len(rows) != DRIVER_CONVERGENCE_M
            or not all(e < DRIVER_CONVERGENCE_BOUND for e in plateau)
            or launches["fdtd_step"] != DRIVER_CONVERGENCE_STEPS):
        failures.append(f"convergence: rows {rows}, launches {launches}")

    out, launches = run_driver(torch, build, results, "suitesparse_scale", [
        "--rows", str(N_ASSEMBLED_SMALL), "--dist"])
    if not (max(out["measured_resid"]) < RESID_BOUND and len(out["top_ritz"]) == K_ASSEMBLED
            and out["mtx_roundtrip"] and launches["windowed_spmm"] > 0
            and out["dist_devices"] == min(torch.cuda.device_count(), 8)
            and out["dist_spmm_nnz_per_s"] > 0):
        failures.append(f"suitesparse_scale: measured residuals "
                        f"{out['measured_resid']}, dist {out.get('dist_devices')} "
                        f"ranks at {out.get('dist_spmm_nnz_per_s')} nnz*col/s, "
                        f"launches {launches}")

    rows, launches = run_driver(torch, build, results, "tune_windowed", [
        "--rows", str(DRIVER_TUNE_ROWS)])
    timed = [r for r in rows if "seconds" in r]
    if len(rows) != 12 or not timed or launches["windowed_spmm"] <= 0:
        failures.append(f"tune_windowed: rows {rows}, launches {launches}")


def multidevice_rank(mesh):
    """One rank of the multidevice phase (spawned by `launch.run`): the
    block slice on `DistributedPallasMaxwell`, its launch counts read from
    0 around the run, then its timings, beside the single-device
    operator's in the same process (the slice is host-bound, so both run
    in turns) and the host time of one all-reduce of a p x p Gram."""
    import torch

    from lanczos_tpu_torch.methods.expm_action import block_lanczos_expm_action
    from lanczos_tpu_torch.methods.fdtd import fdtd_block
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B
    from lanczos_tpu_torch.ops.kernels import build
    from lanczos_tpu_torch.parallel import DistributedPallasMaxwell

    op = DistributedPallasMaxwell.create(N_SLICE, N_SLICE, N_SLICE, mesh)
    b_np = gaussian_matrix_B(N_SLICE, op.n, P_SLICE).astype("float32")
    b = op.pack(torch.from_numpy(b_np))
    tf = op.trace_fn(LC)
    torch.cuda.synchronize()
    build.reset_launches()
    sol = block_lanczos_expm_action(op, b, M_SLICE, 1.0, 0, trace_fn=tf)
    u = fdtd_block(op, b, FDTD_STEPS, 1.0)
    ref = mesh.all_reduce_(tf(u))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)

    sop = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device=mesh.device)
    sb, stf = sop.pack(torch.from_numpy(b_np).to(mesh.device)), sop.trace_fn(LC)
    del b_np
    runs = {"distributed": lambda: block_lanczos_expm_action(
                op, b, M_SLICE, 1.0, 0, trace_fn=tf),
            "single-device fused=False": lambda: block_lanczos_expm_action(
                sop, sb, M_SLICE, 1.0, 0, trace_fn=stf, fused=False)}
    ms_per_iteration = {name: [] for name in runs}
    for _ in range(2):
        for name, fn in runs.items():
            ms_per_iteration[name].append(
                cuda_ms(torch, fn, iters=3, warmup=1) / M_SLICE)
    gram = torch.zeros(P_SLICE, P_SLICE, device=mesh.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_LAUNCHES * 10):
        mesh.all_reduce_(gram)
    torch.cuda.synchronize()
    all_reduce_us = (time.perf_counter() - t0) / (TIMED_LAUNCHES * 10) * 1e6
    fdtd_step_ms = cuda_ms(torch, lambda: fdtd_block(op, b, MULTI_FDTD_TIMED, 1.0),
                           iters=1, warmup=1) / MULTI_FDTD_TIMED
    k1_ms = cuda_ms(torch, lambda: op.mm(b))
    single_k1_ms = cuda_ms(torch, lambda: sop.mm(sb))
    return {"solution": sol, "fdtd": ref, "launches": launches,
            "ms_per_iteration": ms_per_iteration, "all_reduce_us": all_reduce_us,
            "fdtd_ms_per_step": fdtd_step_ms, "k1_ms": k1_ms,
            "single_k1_ms": single_k1_ms, "rows": op.state_shape[1],
            "single_rows": sop.spec.zc}


def slabs_by_hand(torch, sop, b):
    """K1 on MULTI_SLABS z-slabs of the packed block b, all on this card,
    with each slab's halo rows copied in from its neighbours' edge planes
    (what `Mesh.exchange` moves between cards): the rank operators, the
    outputs and the work copies."""
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import apply_stencil_pair
    from lanczos_tpu_torch.parallel import DistributedPallasMaxwell
    from lanczos_tpu_torch.parallel.dist_stencil import TZ, slab_weights
    from lanczos_tpu_torch.parallel.mesh import Mesh

    dev, ops = torch.device("cuda"), []
    for rank in range(MULTI_SLABS):
        specs, wz, wp, zl = slab_weights(N_SLICE, N_SLICE, N_SLICE, MULTI_SLABS,
                                         rank, TZ)
        ops.append(DistributedPallasMaxwell(
            N_SLICE, N_SLICE, N_SLICE, torch.from_numpy(wz).to(dev),
            torch.from_numpy(wp).to(dev), specs,
            Mesh(rank, MULTI_SLABS, dev, None), zl, TZ))
    flat = sop.unpack(b)
    slabs = [op.pack(flat) for op in ops]
    tz, zs = ops[0].tz, ops[0].spec_e.zc
    works = []
    for rank, slab in enumerate(slabs):
        work = slab.clone()
        if rank > 0:
            work[:, :, tz - 1] = slabs[rank - 1][:, :, zs - tz - 1]
        if rank < MULTI_SLABS - 1:
            work[:, :, zs - tz] = slabs[rank + 1][:, :, tz]
        works.append(work)
    outs = [apply_stencil_pair(w, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
            for w, op in zip(works, ops)]
    return ops, outs, works


def phase_multidevice(torch, build, results, failures):
    from lanczos_tpu_torch.config import LanczosConfig
    from lanczos_tpu_torch.cli import run
    from lanczos_tpu_torch.methods.expm_action import block_lanczos_expm_action
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import apply_stencil_pair
    from lanczos_tpu_torch.parallel import launch

    sop, b, tf = block_fixture(torch)
    ops, outs, works = slabs_by_hand(torch, sop, b)
    want = sop.unpack(sop.mm(b))
    got = ops[0].unpack_slabs(torch.stack(outs))
    err, rel, ok = compare(torch, got, want, MULTI_RTOL)
    zl, tz, zs = ops[0].zl, ops[0].tz, ops[0].spec_e.zc
    pads = [bool(o[:, :, :tz].any() or o[:, :, tz + zl:].any()) for o in outs]
    log(f"  {MULTI_SLABS} slabs of Zs={zs} rows (zl={zl} interior, tz={tz}), "
        f"halos by hand: K1 vs the single-device K1 max abs err {err:.3e} "
        f"({rel:.2e} of scale, bound {MULTI_RTOL:g}); nonzero pads {pads}")
    if not ok or any(pads):
        failures.append(f"multidevice: slab K1 err {rel:.3e} of scale, pads {pads}")
    interior = [max(0, min(zl, N_SLICE + 1 - r * zl)) for r in range(MULTI_SLABS)]
    slab_ms = [cuda_ms(torch, lambda w=w, op=op: apply_stencil_pair(
        w, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)) for w, op in zip(works, ops)]
    whole_ms = cuda_ms(torch, lambda: sop.mm(b))
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import apply_stencil_pair_plain

    plain_ms = cuda_ms(torch, lambda: apply_stencil_pair_plain(
        works[0], ops[0].wz_t, ops[0].wplane_s, ops[0].spec_e, ops[0].spec_h))
    for r, ms in enumerate(slab_ms):
        log(f"  row: slab K1 rank {r}: {ms:.4f} ms, {interior[r]} of {zs} rows "
            f"interior ({interior[r] / zs:.1%})")
    log(f"  row: slab K1's plain version (rank 0's slab): {plain_ms:.4f} ms")
    log(f"  row: whole-domain K1 (Zc={sop.spec.zc}): {whole_ms:.4f} ms; linear "
        f"estimate a slab {whole_ms * zs / sop.spec.zc:.4f} ms")
    del ops, outs, works

    # world size 1 on NCCL, against the single-device materialized run
    sol_single = block_lanczos_expm_action(sop, b, M_SLICE, 1.0, 0, trace_fn=tf,
                                           fused=False).cpu()
    del sop, b
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (rank0,) = launch.run(multidevice_rank, 1, device="cuda", timeout=600)
    log(f"  world size 1 through launch.run (NCCL): {time.perf_counter() - t0:.1f} s")
    launches = rank0["launches"]
    results.setdefault("launches", {})["multidevice"] = launches
    log(f"  launches: {launches}")
    sol, ref = rank0["solution"].double(), rank0["fdtd"].double()
    vs_single = float((sol - sol_single.double()).norm() / sol_single.double().norm())
    vs_fdtd = float((sol - ref).norm() / ref.norm())
    single_fdtd = float((sol_single.double() - ref).norm() / ref.norm())
    log(f"  solution {sol.tolist()}; vs single-device fused=False {vs_single:.3e}, "
        f"vs {FDTD_STEPS} FDTD steps {vs_fdtd:.3e} (single-device {single_fdtd:.3e}; "
        f"bound {REL_ERROR_BOUND:g})")
    for name, ms in rank0["ms_per_iteration"].items():
        log(f"  row: ms an iteration (m={M_SLICE}, materialized, in the rank, "
            f"two turns): {name} {ms[0]:.3f}, {ms[1]:.3f}")
    log(f"  row: all-reduce of a {P_SLICE}x{P_SLICE} Gram at world size 1: "
        f"{rank0['all_reduce_us']:.1f} us of host time")
    log(f"  row: K1 at world size 1: {rank0['k1_ms']:.4f} ms on Zs={rank0['rows']} "
        f"rows, single-device {rank0['single_k1_ms']:.4f} ms on "
        f"Zc={rank0['single_rows']} rows")
    log(f"  row: FDTD on the distributed operator (K1 + add): "
        f"{rank0['fdtd_ms_per_step']:.4f} ms a step over {MULTI_FDTD_TIMED} steps")
    log(f"  K1 launches in the rank's run: {launches['apply_stencil_pair']}")
    want_launches = {name: 0 for name in launches}
    want_launches["apply_stencil_pair"] = M_SLICE + FDTD_STEPS
    if launches != want_launches:
        failures.append(f"multidevice: launches {launches}, expected {want_launches}")
    if not (sol.isfinite().all() and len(sol) == P_SLICE and vs_single < REL_ERROR_BOUND
            and vs_fdtd < REL_ERROR_BOUND and single_fdtd < REL_ERROR_BOUND):
        failures.append(f"multidevice: solution {sol.tolist()}, vs single "
                        f"{vs_single}, vs FDTD {vs_fdtd}, single vs FDTD {single_fdtd}")

    too_many = torch.cuda.device_count() + 1
    try:
        run(LanczosConfig(n_grid=N_SLICE, m=M_SLICE, operator="pallas",
                          devices=too_many, device="cuda"))
        failures.append(f"multidevice: --devices {too_many} did not raise")
    except ValueError as e:
        log(f"  --devices {too_many} on {too_many - 1} card(s): ValueError ({e})")
    log("  nvidia-smi:", nvidia_smi_line())


def windowed_rank(mesh, ritz, tmp):
    """One rank of the multidevice windowed phase (spawned by
    `launch.run`): the assembled slice's eigsh on `HaloShardedWindowed`,
    its launch counts read from 0 around it (K8 only), a checkpointed
    block run stopped after its first chunk and resumed against the
    uninterrupted fused=False run, io with a mesh on a small .mtx, and the
    dry run's three steps.  The matrix is rebuilt here from its seed;
    `ritz` are the assembled slice's K8 values; `tmp` a directory."""
    import numpy as np
    import torch
    from scipy.io import mmwrite

    from lanczos_tpu_torch.io import auto_operator, operator_from_file
    from lanczos_tpu_torch.methods import checkpoint as ck
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh, ritz_residuals
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.kernels import build
    from lanczos_tpu_torch.parallel import halo_sharded_windowed
    from lanczos_tpu_torch.parallel.dryrun import dryrun_rank

    out = {}
    t0 = time.perf_counter()
    a = synth_suitesparse_banded(N_ASSEMBLED)
    out["matrix_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = halo_sharded_windowed(a, mesh)
    torch.cuda.synchronize()
    out["shard_s"] = time.perf_counter() - t0
    x = np.random.default_rng(0).standard_normal(
        (P_ASSEMBLED, a.shape[0])).astype(np.float32)
    b = op.pad_vector(torch.from_numpy(x))
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    vals, vecs, bounds = block_lanczos_eigsh(
        op, b, M_ASSEMBLED, K_ASSEMBLED, which="LA", reorth="full",
        normalize="qr", breakdown_eps=1e-4, replace_dead=True,
        eig_backend="newton", compute_vectors=True)
    torch.cuda.synchronize()
    out["eigsh_s"] = time.perf_counter() - t0
    out["in_recurrence"] = build.LAUNCHES["windowed_spmm"]
    resid = ritz_residuals(op, vals, vecs)
    torch.cuda.synchronize()
    out["launches"] = dict(build.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ritz = torch.tensor(ritz, dtype=torch.float64)
    out.update(vals=vals, resid=resid, bounds=bounds,
               ritz_rel=((vals.double().cpu() - ritz).abs() / ritz.abs()).max().item(),
               halo=op.halo, rows_loc=op.rows_loc, n128=op.n128)
    del vecs
    out["mm_ms"] = cuda_ms(torch, lambda: op.mm(b))

    ref = block_lanczos(op, b, M_CHECKPOINT, 0, fused=False)
    path = os.path.join(tmp, "ck.npz")
    real = ck._Sharding.write
    calls = []

    def stop_after_first(self, save):
        if calls:
            raise StopAfterFirstChunk
        calls.append(1)
        return real(self, save)

    ck._Sharding.write = stop_after_first
    try:
        ck.block_lanczos_checkpointed(op, b, M_CHECKPOINT, 0,
                                      chunk=CHUNK_CHECKPOINT, path=path)
        out["stopped"] = False
    except StopAfterFirstChunk:
        out["stopped"] = True
    finally:
        ck._Sharding.write = real
    with np.load(path) as z:
        out["stopped_at"] = int(z["j"])
    got = ck.block_lanczos_checkpointed(op, b, M_CHECKPOINT, 0,
                                        chunk=CHUNK_CHECKPOINT, path=path)
    out["resumed"] = {name: (compare(torch, getattr(got, name), getattr(ref, name),
                                     KERNEL_RTOL["float32"]),
                             torch.equal(getattr(got, name), getattr(ref, name)))
                      for name in ("alphas", "betas", "trace", "beta_final")}
    del op, b, ref, got
    torch.cuda.empty_cache()

    mtx = os.path.join(tmp, "slab.mtx")
    mmwrite(mtx, a[:2000, :2000].tocoo())
    out["io"] = [type(operator_from_file(mtx, format=f, mesh=mesh)).__name__
                 for f in ("windowed", "auto")]
    out["io"].append(type(auto_operator(a[:2000, :2000], mesh=mesh)).__name__)
    del a
    t0 = time.perf_counter()
    dry = dryrun_rank(mesh)
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_top"] = (float(dry["vals"][0]), float(dry["vals_w"][0]))
    return out


def windowed_shards_by_hand(torch, a, n_dev, X, **kw):
    """Every rank's `HaloShardedWindowed` of a on n_dev ranks, built in
    this process on the card (a `Mesh` with no process group), the ranks'
    state strips of the natural-order (p, n) X, and their work strips:
    each strip's halo slots filled by hand from its neighbours' rows (what
    `Mesh.halo_strips` moves between cards).  (ops, strips, works, build
    seconds)."""
    from lanczos_tpu_torch.parallel import halo_sharded_windowed
    from lanczos_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops = [halo_sharded_windowed(a, Mesh(rank, n_dev, dev, None), **kw)
           for rank in range(n_dev)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if ops[0].perm is not None:
        raise RuntimeError("the by-hand shards assume no reordering")
    h, rl = ops[0].halo, ops[0].rows_loc
    n = X.shape[1]
    strips = [op.pad_vector(X) for op in ops]
    ext = torch.cat([X.new_zeros((X.shape[0], h)), X,
                     X.new_zeros((X.shape[0], n_dev * rl - n + h))], dim=1)
    works = []
    for rank, strip in enumerate(strips):
        work = strip.clone()
        work[:, : rl + 2 * h] = ext[:, rank * rl : rank * rl + rl + 2 * h]
        works.append(work)
    return ops, strips, works, build_s


def strip_outside_rows(op, y, rank):
    """y's entries outside this rank's rows of the matrix: its halo slots,
    the last rank's rows past n and the pad."""
    rows = max(0, min(op.rows_loc, op.n_rows_true - rank * op.rows_loc))
    outside = y.clone()
    outside[:, op.halo : op.halo + rows] = 0
    return outside


def phase_multidevice_windowed(torch, build, results, failures, assembled):
    """The row-sharded windowed-ELL operator on the assembled slice's
    matrix: four shards by hand in this process, K8 on each, against the
    single-device K8 and each shard's plain version; a two-hop case
    against scipy; then world size 1 through launch.run on NCCL
    (`windowed_rank`).  Leaves the matrix, its plan and the Ritz values
    to the multidevice ell phase."""
    import tempfile

    import numpy as np

    from lanczos_tpu_torch.ops.kernels.window_ell import (
        windowed_spmm,
        windowed_spmm_plain,
    )
    from lanczos_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    a, A, ritz = assembled["a"], assembled["A"], assembled["ritz"]
    n = a.shape[0]
    x = np.random.default_rng(2).standard_normal((P_ASSEMBLED, n)).astype(np.float32)
    X = torch.from_numpy(x).to(dev)
    del x
    k8 = windowed_spmm(A, A.pack(X))[:, :n].clone()
    ops, strips, works, build_s = windowed_shards_by_hand(torch, a, MULTI_SLABS, X)
    h, rl = ops[0].halo, ops[0].rows_loc
    outs = [op.local.padded_mm(w) for op, w in zip(ops, works)]
    got = ops[0].unpad_shards(torch.stack(outs))
    err, rel, ok = compare(torch, got, k8, KERNEL_RTOL["float32"])
    outside = any(bool(strip_outside_rows(op, y, r).any())
                  for r, (op, y) in enumerate(zip(ops, outs)))
    log(f"  {MULTI_SLABS} windowed shards of {rl} rows (halo {h}, "
        f"{-(-h // rl)} hop(s), strip {ops[0].n128}; ppc "
        f"{[op.local.ppc for op in ops]}, wsz {[op.local.wsz for op in ops]}), "
        f"planned on the host in {build_s:.2f} s, work strips by hand: stitched "
        f"vs the single-device K8 rel {rel:.2e} (tol {KERNEL_RTOL['float32']:.0e}, "
        f"bit-equal {torch.equal(got, k8)}); halo slots and pad rows nonzero "
        f"{outside}")
    if not ok or outside:
        failures.append(f"multidevice windowed: shards vs K8 {rel}, halo/pad "
                        f"nonzero {outside}")
    for r, (op, w, y) in enumerate(zip(ops, works, outs)):
        e, rel_p, ok_p = compare(torch, y, windowed_spmm_plain(op.local, w),
                                 KERNEL_RTOL["float32"])
        log(f"  K8 shard {r} vs plain: max_abs_err {e:.3e} rel {rel_p:.3e} "
            f"{'ok' if ok_p else 'FAIL'}")
        if not ok_p:
            failures.append(f"multidevice windowed: shard {r}'s K8 disagrees "
                            "with its plain version")
    del got, k8, outs
    # each shard's K8 and its work copy, timed; the plain version and
    # cuSPARSE on the shard's own CSR rows over the window beside them
    for r, (op, strip, w) in enumerate(zip(ops, strips, works)):
        L = op.local
        buf = torch.empty_like(w)
        ms = cuda_ms(torch, lambda: windowed_spmm(L, w, buf))
        copy_ms = cuda_ms(torch, lambda: strip.clone())
        line = (f"  row: K8 shard {r} of {MULTI_SLABS} p={P_ASSEMBLED}: {ms:.4f} ms, "
                f"work copy {copy_ms:.4f} ms")
        if r == 1:  # an interior shard: its plain version, bound and library
            plain_ms = cuda_ms(torch, lambda: windowed_spmm_plain(L, w), iters=3)
            lo = r * rl
            blk = a[lo : min(lo + rl, n)]
            csr = torch.sparse_csr_tensor(
                torch.from_numpy(blk.indptr.astype(np.int64)).to(dev),
                torch.from_numpy(blk.indices.astype(np.int64) - (lo - h)).to(dev),
                torch.from_numpy(blk.data).to(dev), size=(blk.shape[0], rl + 2 * h))
            win = w[:, : rl + 2 * h]
            lib_ms = min(cuda_ms(torch, lambda xt=xt: torch.sparse.mm(csr, xt))
                         for xt in (win.T.contiguous(), win.T))
            nbytes = (sum(t.numel() * t.element_size() for t in
                          (L.planes_data, L.planes_lidx, L.planes_off, L.wb))
                      + 2 * w.numel() * w.element_size())
            bound_ms, by = bound(nbytes, 2 * blk.nnz * P_ASSEMBLED, "float32")
            line += (f"; {nbytes / 1e6:.1f} MB/call, bound {bound_ms:.4f} ms ({by}), "
                     f"plain {plain_ms:.4f} ms, cuSPARSE on the shard's CSR "
                     f"{lib_ms:.4f} ms ({blk.nnz} nnz)")
            del csr, win
        log(line)
    log(f"  row: K8 whole matrix p={P_ASSEMBLED}: "
        f"{results['rows']['windowed_spmm']['ms']:.4f} ms")
    del ops, strips, works, X
    torch.cuda.empty_cache()
    two_hops_case(torch, failures)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (r,) = launch.run(windowed_rank, 1, [float(v) for v in ritz], tmp,
                          device="cuda", timeout=600)
        wall = time.perf_counter() - t0
    results.setdefault("launches", {})["multidevice windowed"] = r["launches"]
    vals, resid = r["vals"].numpy(), r["resid"].numpy()
    log(f"  world size 1 through launch.run (NCCL): {wall:.1f} s; in the rank: "
        f"matrix {r['matrix_s']:.2f} s, shard planned {r['shard_s']:.2f} s (halo "
        f"{r['halo']}, {r['rows_loc']} rows, strip {r['n128']})")
    log(f"  eigsh p={P_ASSEMBLED} m={M_ASSEMBLED} k={K_ASSEMBLED} on "
        f"HaloShardedWindowed: launches {r['launches']} ({r['in_recurrence']} in "
        f"the recurrence); Ritz {vals.tolist()}, vs the K8 run's max rel "
        f"{r['ritz_rel']:.2e} (tol {EIGSH_RTOL:g}); measured residuals "
        f"{resid.tolist()} (bound {RESID_BOUND:g})")
    log(f"  row: eigsh wall {r['eigsh_s']:.3f} s on HaloShardedWindowed; peak "
        f"device memory {r['peak_gib']:.2f} GiB; its product p={P_ASSEMBLED} "
        f"{r['mm_ms']:.4f} ms")
    same = {k: v[1] for k, v in r["resumed"].items()}
    log(f"  checkpointed block run (m={M_CHECKPOINT}, chunk {CHUNK_CHECKPOINT}) "
        f"stopped at j={r['stopped_at']} and resumed vs fused=False: bit-equal "
        f"{same}")
    log(f"  io with a mesh (windowed, auto, auto_operator): {r['io']}; dry run "
        f"{r['dryrun_s']:.2f} s, top Ritz halo ELL / windowed {r['dryrun_top']}")
    log("  nvidia-smi:", nvidia_smi_line())
    others = {k: c for k, c in r["launches"].items() if c and k != "windowed_spmm"}
    if r["in_recurrence"] != M_ASSEMBLED or r["launches"]["windowed_spmm"] != M_ASSEMBLED + 1 or others:
        failures.append(f"multidevice windowed: launches {r['launches']} "
                        f"({r['in_recurrence']} in the recurrence), expected K8 "
                        f"{M_ASSEMBLED} and {M_ASSEMBLED + 1} and nothing else")
    if not (np.all(np.isfinite(vals)) and r["ritz_rel"] <= EIGSH_RTOL
            and np.all(resid < RESID_BOUND)):
        failures.append(f"multidevice windowed: Ritz {vals} (rel {r['ritz_rel']}), "
                        f"residuals {resid}")
    if not (r["stopped"] and r["stopped_at"] == 1 + CHUNK_CHECKPOINT
            and all(v[0][2] for v in r["resumed"].values())):
        failures.append(f"multidevice windowed: checkpoint resume {r['resumed']}, "
                        f"stopped {r['stopped']} at {r['stopped_at']}")
    if r["io"] != ["HaloShardedWindowed"] * 3:
        failures.append(f"multidevice windowed: io with a mesh built {r['io']}")


def two_hops_case(torch, failures):
    """JAX's test_matches_single_chip_windowed matrix (n=900, a random band
    of half-width 300 over a 30 x 30 Laplacian) on 4 windowed shards of
    256 rows by hand: a halo of 2 hops; against scipy's f64 product, the
    halo slots and pads zero."""
    import numpy as np
    import scipy.sparse as sp

    from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy

    n = 900
    d = sp.random(n, n, density=0.002, random_state=3, format="coo")
    keep = np.abs(d.row - d.col) <= 300
    d = sp.coo_matrix((d.data[keep], (d.row[keep], d.col[keep])), shape=(n, n))
    a = (laplacian_2d_scipy(30, 30) + d + d.T).tocsr().astype(np.float32)
    x = np.random.default_rng(3).standard_normal((3, n))
    X = torch.from_numpy(x).float().cuda()
    ops, _, works, _ = windowed_shards_by_hand(torch, a, MULTI_SLABS, X, cpb=2,
                                               spg=2, reorder="none")
    outs = [op.local.padded_mm(w) for op, w in zip(ops, works)]
    y = ops[0].unpad_shards(torch.stack(outs))
    err, rel, ok = compare(torch, y.cpu(), torch.from_numpy((a.astype(np.float64) @ x.T).T),
                           K8_SCIPY_RTOL)
    hops = -(-ops[0].halo // ops[0].rows_loc)
    outside = any(bool(strip_outside_rows(op, o, r).any())
                  for r, (op, o) in enumerate(zip(ops, outs)))
    log(f"  two-hop case: n={n} on {MULTI_SLABS} shards of {ops[0].rows_loc} rows, "
        f"halo {ops[0].halo} ({hops} hops): vs scipy rel {rel:.2e}; halo slots and "
        f"pads nonzero {outside}")
    if not ok or hops != 2 or outside:
        failures.append(f"multidevice windowed: two-hop case rel {rel}, hops "
                        f"{hops}, halo/pad nonzero {outside}")


def ell_rank(mesh, ritz, path):
    """One rank of the multidevice ell phase (spawned by `launch.run`):
    the assembled slice's eigsh on `HaloShardedEll`, its launch counts
    read from 0 around it (this path runs no kernel of the repo), then one
    `GatherShardedEll` product against the halo product, and a checkpointed
    block run stopped after its first chunk and resumed against the
    uninterrupted fused=False run.  The matrix is rebuilt here from its
    seed; `ritz` are the assembled slice's K8 values."""
    import numpy as np
    import torch

    from lanczos_tpu_torch.methods import checkpoint as ck
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh, ritz_residuals
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.kernels import build
    from lanczos_tpu_torch.parallel import gather_sharded_ell, halo_sharded_ell

    out = {}
    t0 = time.perf_counter()
    a = synth_suitesparse_banded(N_ASSEMBLED)
    out["matrix_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = halo_sharded_ell(a, mesh)
    out["halo_build_s"] = time.perf_counter() - t0
    x = np.random.default_rng(0).standard_normal(
        (P_ASSEMBLED, a.shape[0])).astype(np.float32)
    b = op.pad_vector(torch.from_numpy(x))
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    vals, vecs, bounds = block_lanczos_eigsh(
        op, b, M_ASSEMBLED, K_ASSEMBLED, which="LA", reorth="full",
        normalize="qr", breakdown_eps=1e-4, replace_dead=True,
        eig_backend="newton", compute_vectors=True)
    torch.cuda.synchronize()
    out["eigsh_s"] = time.perf_counter() - t0
    resid = ritz_residuals(op, vals, vecs)
    torch.cuda.synchronize()
    out["launches"] = dict(build.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ritz = torch.tensor(ritz, dtype=torch.float64)
    out.update(vals=vals, resid=resid, bounds=bounds,
               ritz_rel=((vals.double().cpu() - ritz).abs() / ritz.abs()).max().item(),
               halo=op.halo, rows_loc=op.rows_loc)
    del vecs
    out["halo_ms"] = cuda_ms(torch, lambda: op.mm(b))

    t0 = time.perf_counter()
    gop = gather_sharded_ell(a, mesh)
    out["gather_build_s"] = time.perf_counter() - t0
    y_halo, y_gather = op.mm(b), gop.mm(b)
    out["gather_err"] = compare(torch, y_gather, y_halo, KERNEL_RTOL["float32"])
    out["gather_bit_equal"] = torch.equal(y_gather, y_halo)
    del y_halo, y_gather
    out["gather_ms"] = cuda_ms(torch, lambda: gop.mm(b))
    del gop
    torch.cuda.empty_cache()

    ref = block_lanczos(op, b, M_CHECKPOINT, 0, fused=False)
    real = ck._Sharding.write
    calls = []

    def stop_after_first(self, save):
        if calls:
            raise StopAfterFirstChunk
        calls.append(1)
        return real(self, save)

    ck._Sharding.write = stop_after_first
    try:
        ck.block_lanczos_checkpointed(op, b, M_CHECKPOINT, 0,
                                      chunk=CHUNK_CHECKPOINT, path=path)
        out["stopped"] = False
    except StopAfterFirstChunk:
        out["stopped"] = True
    finally:
        ck._Sharding.write = real
    with np.load(path) as z:
        out["stopped_at"] = int(z["j"])
    got = ck.block_lanczos_checkpointed(op, b, M_CHECKPOINT, 0,
                                        chunk=CHUNK_CHECKPOINT, path=path)
    out["resumed"] = {name: (compare(torch, getattr(got, name), getattr(ref, name),
                                     KERNEL_RTOL["float32"]),
                             torch.equal(getattr(got, name), getattr(ref, name)))
                      for name in ("alphas", "betas", "trace", "beta_final")}
    return out


def shards_by_hand(torch, a, n_dev, X, reorder="auto"):
    """Every rank's `halo_shard` of a on n_dev ranks, built in this process
    on the card, each window filled from its neighbours' rows (what
    `Mesh.halo_window` moves between cards), and the local products:
    (shards, windows, outputs, build seconds).  X is the block-major
    (p, n_pad) global state."""
    import numpy as np

    from lanczos_tpu_torch.parallel.dist_operator import halo_shard, local_spmm

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    shards = []
    for rank in range(n_dev):
        data, idx, halo, rows, perm = halo_shard(a, n_dev, rank, np.float32,
                                                 reorder)
        if perm is not None:
            raise RuntimeError("the by-hand shards assume no reordering")
        shards.append((torch.from_numpy(data).to(dev), torch.from_numpy(idx).to(dev)))
    build_s = time.perf_counter() - t0
    zeros = X.new_zeros((X.shape[0], halo))
    ext = torch.cat([zeros, X, zeros], dim=1)
    windows = [ext[:, r * rows : r * rows + rows + 2 * halo].contiguous()
               for r in range(n_dev)]
    outs = [local_spmm(d, i, w) for (d, i), w in zip(shards, windows)]
    return shards, windows, outs, build_s, halo, rows


def phase_multidevice_ell(torch, build, results, failures, assembled):
    """The row-sharded ELL operators on the assembled slice's matrix:
    four shards by hand in this process against the single-device ELL
    product and K8's, a small hops-3 case against scipy, then world size 1
    through launch.run on NCCL (`ell_rank`)."""
    import tempfile

    import numpy as np

    from lanczos_tpu_torch.ops.formats import ell_from_scipy
    from lanczos_tpu_torch.ops.kernels.window_ell import windowed_spmm
    from lanczos_tpu_torch.parallel import launch
    from lanczos_tpu_torch.parallel.dist_operator import local_spmm

    dev = torch.device("cuda")
    # the matrix, its K8 plan and the K8 run's Ritz values leave `assembled`
    a, A, ritz = (assembled.pop(key) for key in ("a", "A", "ritz"))
    n = a.shape[0]
    x = np.random.default_rng(2).standard_normal((P_ASSEMBLED, n)).astype(np.float32)
    X = torch.from_numpy(x).to(dev)
    k8 = windowed_spmm(A, A.pack(X))[:, :n].clone()
    del A, x
    torch.cuda.empty_cache()
    shards, windows, outs, build_s, halo, rows = shards_by_hand(
        torch, a, MULTI_SLABS, X)
    hops = -(-halo // rows)
    stitched = torch.cat(outs, dim=1)
    pad = stitched[:, n:]
    got = stitched[:, :n]
    ell = ell_from_scipy(a, device=dev)
    whole = ell.mm(X)
    err, rel, ok = compare(torch, got, whole, 1e-5)
    err8, rel8, ok8 = compare(torch, got, k8, KERNEL_RTOL["float32"])
    log(f"  {MULTI_SLABS} halo-ELL shards of {rows} rows (halo {halo}, {hops} "
        f"hop(s)), built on the host in {build_s:.2f} s, windows by hand: vs the "
        f"single-device EllMatrix product rel {rel:.2e} (bit-equal "
        f"{torch.equal(got, whole)}), vs K8 rel {rel8:.2e} (tol "
        f"{KERNEL_RTOL['float32']:.0e}); {pad.shape[1]} pad rows, nonzero "
        f"{bool(pad.any())}")
    if not (ok and ok8) or pad.any() or hops != 1:
        failures.append(f"multidevice ell: shards vs EllMatrix {rel}, vs K8 "
                        f"{rel8}, pad rows nonzero {bool(pad.any())}, hops {hops}")
    shard_ms = [cuda_ms(torch, lambda d=d, i=i, w=w: local_spmm(d, i, w))
                for (d, i), w in zip(shards, windows)]
    whole_ms = cuda_ms(torch, lambda: ell.mm(X))
    for r, ms in enumerate(shard_ms):
        log(f"  row: halo-ELL SpMM p={P_ASSEMBLED}, shard {r} of {MULTI_SLABS} "
            f"({rows} rows + 2 x {halo} halo): {ms:.4f} ms")
    log(f"  row: halo-ELL SpMM p={P_ASSEMBLED}, whole matrix (the local "
        f"product at world size 1): {whole_ms:.4f} ms, "
        f"{a.nnz * P_ASSEMBLED / (whole_ms * 1e-3):.4e} nnz*col/s; "
        f"K8 {results['rows']['windowed_spmm']['ms']:.4f} ms")
    del a, shards, windows, outs, stitched, pad, got, ell, whole, k8, X
    torch.cuda.empty_cache()
    hops3_case(torch, failures)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (r,) = launch.run(ell_rank, 1, [float(v) for v in ritz],
                          os.path.join(tmp, "ck.npz"), device="cuda", timeout=600)
        wall = time.perf_counter() - t0
    results.setdefault("launches", {})["multidevice ell"] = r["launches"]
    vals, resid = r["vals"].numpy(), r["resid"].numpy()
    log(f"  world size 1 through launch.run (NCCL): {wall:.1f} s; in the rank: "
        f"matrix {r['matrix_s']:.2f} s, halo ELL built {r['halo_build_s']:.2f} s "
        f"(halo {r['halo']}, {r['rows_loc']} rows), gathered ELL built "
        f"{r['gather_build_s']:.2f} s")
    log(f"  eigsh p={P_ASSEMBLED} m={M_ASSEMBLED} k={K_ASSEMBLED} on HaloShardedEll: "
        f"Ritz {vals.tolist()}, vs the K8 run's max rel {r['ritz_rel']:.2e} (tol "
        f"{EIGSH_RTOL:g}); measured residuals {resid.tolist()} (bound "
        f"{RESID_BOUND:g}); launches {r['launches']}")
    log(f"  row: eigsh wall {r['eigsh_s']:.3f} s on HaloShardedEll; peak device "
        f"memory {r['peak_gib']:.2f} GiB")
    log(f"  row: halo-ELL SpMM p={P_ASSEMBLED} at world size 1: {r['halo_ms']:.4f} ms; "
        f"all-gather ELL SpMM: {r['gather_ms']:.4f} ms (vs halo rel "
        f"{r['gather_err'][1]:.2e}, bit-equal {r['gather_bit_equal']})")
    same = {k: v[1] for k, v in r["resumed"].items()}
    log(f"  checkpointed block run (m={M_CHECKPOINT}, chunk {CHUNK_CHECKPOINT}) stopped "
        f"at j={r['stopped_at']} and resumed vs fused=False: bit-equal {same}, rel "
        f"{ {k: v[0][1] for k, v in r['resumed'].items()} }")
    log("  nvidia-smi:", nvidia_smi_line())
    if any(r["launches"].values()):
        failures.append(f"multidevice ell: a repo kernel launched: {r['launches']}")
    if not (np.all(np.isfinite(vals)) and r["ritz_rel"] <= EIGSH_RTOL
            and np.all(resid < RESID_BOUND)):
        failures.append(f"multidevice ell: Ritz {vals} (rel {r['ritz_rel']}), "
                        f"residuals {resid}")
    if not r["gather_err"][2]:
        failures.append(f"multidevice ell: gathered vs halo product {r['gather_err']}")
    if not (r["stopped"] and r["stopped_at"] == 1 + CHUNK_CHECKPOINT
            and all(v[0][2] for v in r["resumed"].values())):
        failures.append(f"multidevice ell: checkpoint resume {r['resumed']}, "
                        f"stopped {r['stopped']} at {r['stopped_at']}")


def hops3_case(torch, failures):
    """A dense-coupling arrow matrix (1001 rows) on 4 shards by hand: a
    halo of 745 over 256-row shards, 3 hops; against scipy's f64 product,
    its 23 pad rows zero."""
    import numpy as np
    import scipy.sparse as sp

    n = 1001
    arrow = sp.lil_matrix((n, n))
    arrow.setdiag(2.0)
    arrow[0, :] = 1.0
    arrow[:, 0] = 1.0
    arrow = arrow.tocsr()
    from lanczos_tpu_torch.parallel.dist_operator import shard_rows

    x = np.random.default_rng(3).standard_normal((3, n))
    rows = shard_rows(n, MULTI_SLABS)
    X = torch.zeros((3, MULTI_SLABS * rows), device="cuda")
    X[:, :n] = torch.from_numpy(x).float()
    _, _, outs, _, halo, rows = shards_by_hand(torch, arrow, MULTI_SLABS, X,
                                               reorder="none")
    y = torch.cat(outs, dim=1)
    err, rel, ok = compare(torch, y[:, :n].cpu(), torch.from_numpy((arrow @ x.T).T),
                           K8_SCIPY_RTOL)
    hops = -(-halo // rows)
    log(f"  hops-3 case: arrow n={n} on {MULTI_SLABS} shards of {rows} rows, halo "
        f"{halo} ({hops} hops): vs scipy rel {rel:.2e}; pad rows nonzero "
        f"{bool(y[:, n:].any())}")
    if not ok or hops != 3 or y[:, n:].any():
        failures.append(f"multidevice ell: hops-3 case rel {rel}, hops {hops}")


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch does not import ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    try:
        from lanczos_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: lanczos_tpu_torch not found beside the script ({e})",
              file=sys.stderr)
        return 2

    results, failures, assembled = {}, [], {}
    phases = (
        ("environment", lambda: phase_environment(torch, build)),
        ("build", lambda: phase_build(build)),
        ("kernels", lambda: phase_kernels(torch, results, failures)),
        ("native", lambda: phase_native(torch, failures, assembled)),
        ("windowed kernel",
         lambda: phase_windowed_kernel(torch, results, failures, assembled)),
        ("block slice",
         lambda: phase_block_slice(torch, build, results, failures)),
        ("vector slice",
         lambda: phase_vector_slice(torch, build, results, failures)),
        ("compensated slice",
         lambda: phase_compensated_slice(torch, build, results, failures)),
        ("bf16", lambda: phase_bf16(torch, build, results, failures)),
        ("assembled slice",
         lambda: phase_assembled_slice(torch, build, results, failures,
                                       assembled)),
        ("multidevice windowed",
         lambda: phase_multidevice_windowed(torch, build, results, failures,
                                            assembled)),
        ("multidevice ell",
         lambda: phase_multidevice_ell(torch, build, results, failures,
                                       assembled)),
        ("ell slice",
         lambda: phase_ell_slice(torch, build, results, failures)),
        ("unpaired pair",
         lambda: phase_unpaired_pair(torch, build, results, failures)),
        ("checkpoint",
         lambda: phase_checkpoint(torch, build, results, failures)),
        ("profile",
         lambda: phase_profile(torch, build, results, failures)),
        ("bench", lambda: phase_bench(torch, build, results, failures)),
        ("drivers", lambda: phase_drivers(torch, build, results, failures)),
        ("multidevice",
         lambda: phase_multidevice(torch, build, results, failures)),
    )
    t_start = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
        except Exception:  # a phase that raises fails the run, reported here
            failures.append(f"phase {name} raised:\n{traceback.format_exc()}")
            if name in ("environment", "build"):
                break
        log(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")
    log(f"[all phases: {time.perf_counter() - t_start:.1f} s]")

    rows = results.get("rows", {})
    keys = list(REPLACES) + [f"{k} p=1" for k in P1_ROWS] + list(BF16_ROWS)
    missing = [k for k in keys if k not in rows]
    if failures or missing:
        for f in failures or [f"no kernel results for {missing}"]:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    paths = results.get("launches", {})
    # a p=1 row counts its kernel's launches at p=1 in the vector slices
    # (the CLI's, the assembled eigsh's), the main row every other launch
    # (the bench's and the drivers' included)
    at_p1 = results.get("p1_launches", {})

    def launches(key):
        counter = key.removesuffix(" p=1")  # a LAUNCHES name
        total = sum(c.get(counter, 0) for c in paths.values())
        at_one = at_p1.get(counter, 0)
        return at_one if key.endswith(" p=1") else total - at_one

    kernels = [rows[k] | {"launches": launches(k)} for k in keys]
    if any(k["launches"] <= 0 for k in kernels):
        print(f"chip_smoke FAILED: a kernel never launched on a main path: "
              f"{kernels}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
