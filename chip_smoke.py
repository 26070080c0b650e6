#!/usr/bin/env python3
"""Smoke test of lanczos_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  Phases, each of which must pass:

1. environment: torch / CUDA / nvcc / triton versions, the card's name and
   power limit;
2. build: the eight hand-written CUDA kernels (K1-K8) from
   lanczos_tpu_torch/csrc, with nvcc's register/spill report;
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
   e^+-6, at a bound that K3's f32 sums must miss; K6, the generic
   stencil, against its plain version at small geometries (6 -> 3 fields
   with 27 taps per output, a 7-point 1 -> 1 set, an odd Zc; p=1 and p=3;
   f32 and f64), then at the Maxwell N=160 p=4 half-call, timed;
4. K8 vs plain: the windowed-ELL SpMM at small odd geometries (a 300x900
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
9. the ELL slice: `--operator ell` (N=64, m=6, p=4, 2000 FDTD steps):
   the gathered ELL product is plain torch, and the 25 MB block state
   passes the 16 MB gate, so the fused recurrence runs K2/K3 on flat
   (p, n) states; relative error under 1e-3;
10. the unpaired pair: A U at N=160 p=4 through `apply_stencil_pair`
    with paired=False on both halves, two K6 launches and no K1, within
    1e-5 of K1's paired A U, both timed; then K5 (its own kernel, one
    launch) and K4 (K3 and K6 launches) with the same unpaired specs,
    each against its plain version;
11. checkpoint/resume at N=160 p=4: `block_lanczos_checkpointed` (m=6,
    chunk 3) against `block_lanczos(fused=False)`; a run stopped at j=4
    and resumed, and an FDTD run (2000 steps, chunks of 1000) stopped
    after its first chunk and resumed, each equal to its uninterrupted
    run bit for bit (K5 2000 times); the seconds and MB of every save;
12. the profile: the block slice's Lanczos through `run` with --profile
    and --no-validate; the Chrome trace names stencil_gram_kernel and
    the launch counts are the block slice's without its FDTD.

Each slice phase (and phases 10-12) sets the launch counts to 0 just
before it drives its path and reads them just after.

The FDTD oracle's forward-Euler error falls as 1/steps; the CLI's default
is 10^6 steps, the smoke takes 2000 to fit its time budget.

Output: one JSON line of per-kernel results (launches summed over the
slices; bound_ms the larger of the bytes over the card's memory rate and
the operations over its peak rate; K3 and K8 also at p=1, in rows of their
own that count the launches at p=1, and so K1 and K5, whose p=1 rows
count the vector slice's launches), the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
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
N_ELL, M_ELL = 64, 6  # a p=4 state of 25 MB: over the 16 MB fused gate
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
# the kernels with a row of their own at p=1: K1 and K3 run at p=1 in every
# step of the vector slice and K5 in every step of its FDTD, K8 in every
# step of the assembled vector eigsh
P1_ROWS = ("block_grams", "windowed_spmm", "apply_stencil_pair", "fdtd_step")
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
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    # ptxas -v: registers and spills per kernel instantiation, e.g.
    # "stencil_gram_kernel<f,4>: 98 registers, 0 bytes spill stores" or
    # "gram_kernel<f,d,f,8,4,4>" (operand, sum and output types, R, C, VEC)
    name, spills = None, ""
    for ln in build.build_log.splitlines():
        m = re.search(r"\d([a-z][a-z_]*_kernel)(?:I([fd]+)((?:Li\d+E)*)E)?", ln)
        if "Compiling entry function" in ln and m:
            args = list(m.group(2) or "") + re.findall(r"Li(\d+)E", m.group(3) or "")
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
                               lambda: coeffs.T @ stack.flatten(1))
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
        scratch = dst.clone()
        record("apply_stencil_pair_gram", "K4 apply_stencil_pair_gram g3",
               got_g3, want_g3, lambda: op.stencil_gram(q, work),
               lambda: stencil_gram.apply_stencil_pair_gram_plain(
                   q, scratch, op.wz_t, op.wplane_s, op.spec_e, op.spec_h),
               3 * state_bytes, 12 * p * S + 3 * 2 * p * p * S)
        del q, dst, work, scratch, want_v, want_g3, got_v, got_g3

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
    k6_vs_plain(torch, rows, failures)


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
    for name in ("block_grams", "apply_stencil_pair", "fdtd_step"):
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


def phase_windowed_kernel(torch, results, failures, assembled):
    """K8 against its plain version at small odd geometries (p=3 and p=1,
    f32 and f64), then at the assembled slice's shape, p=8 and p=1, timed
    against plain, a device copy of the state and cuSPARSE; at p=8 also
    against scipy's f64 product.  Leaves the 10.5M-row matrix and its plan
    in `assembled` for the slice phase."""
    import numpy as np

    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
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

    t0 = time.perf_counter()
    a = synth_suitesparse_banded(N_ASSEMBLED)
    log(f"assembled matrix: {a.shape[0]} rows, {a.nnz} nnz, "
        f"{time.perf_counter() - t0:.2f} s on the host")
    t0 = time.perf_counter()
    A = windowed_from_scipy(a, reorder="none", device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    log(f"  plan {plan_s:.2f} s: ppc {A.ppc}, wsz {A.wsz}, ng {A.ng}, "
        f"n128 {A.n128}, {A.device_bytes() / 1e6:.1f} MB on the device")
    assembled.update(a=a, A=A)

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
    assembled.clear()
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
    plain version: K5 in its own kernel (one launch), K4 as K3, two K6
    and K3 launches (no K4)."""
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
    checks["K4 unpaired v"] = (k4_launches, {"block_grams": 2, "apply_stencil": 2},
                               v, want_v)
    checks["K4 unpaired g3"] = (k4_launches, {"block_grams": 2, "apply_stencil": 2},
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
        ("windowed kernel",
         lambda: phase_windowed_kernel(torch, results, failures, assembled)),
        ("block slice",
         lambda: phase_block_slice(torch, build, results, failures)),
        ("vector slice",
         lambda: phase_vector_slice(torch, build, results, failures)),
        ("compensated slice",
         lambda: phase_compensated_slice(torch, build, results, failures)),
        ("assembled slice",
         lambda: phase_assembled_slice(torch, build, results, failures,
                                       assembled)),
        ("ell slice",
         lambda: phase_ell_slice(torch, build, results, failures)),
        ("unpaired pair",
         lambda: phase_unpaired_pair(torch, build, results, failures)),
        ("checkpoint",
         lambda: phase_checkpoint(torch, build, results, failures)),
        ("profile",
         lambda: phase_profile(torch, build, results, failures)),
    )
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

    rows = results.get("rows", {})
    keys = list(REPLACES) + [f"{k} p=1" for k in P1_ROWS]
    missing = [k for k in keys if k not in rows]
    if failures or missing:
        for f in failures or [f"no kernel results for {missing}"]:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    paths = results.get("launches", {})
    # a p=1 row counts its kernel's launches at p=1, the main row every
    # other launch
    at_p1 = results.get("p1_launches", {})

    def launches(key):
        name, _, width = key.partition(" ")
        total = sum(c[name] for c in paths.values())
        return at_p1.get(name, 0) if width else total - at_p1.get(name, 0)

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
