#!/usr/bin/env python3
"""Smoke test of lanczos_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  Phases, each of which must pass:

1. environment: torch / CUDA / nvcc / triton versions, the card's name and
   power limit;
2. build: the six hand-written CUDA kernels (K1-K5, K7) from
   lanczos_tpu_torch/csrc, with nvcc's register/spill report;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main paths' shapes (Maxwell N=160 at p=4, the block
   slices, and at p=1, the vector slice; K4 and K7 at p=4 only, the vector
   slice runs neither) and at a small odd geometry (N=11, p=3, f32 and
   f64; K7 takes f32 only), with the tolerance stated below, and timed
   against its plain version and against a device copy of the same bytes;
   K7 also against the f64 Gram on inputs spread over e^+-6, at a bound
   that K3's f32 sums must miss;
4. the block slice end to end through the CLI's `run`: N=160, m=6, p=4,
   --operator pallas, 2000 FDTD steps.  It checks that the path went
   through K1-K5 (the stencil_gram count equals m - 2: the fused mono step
   ran; K1 only in Lanczos, K5 for every FDTD step), that the solution is
   finite and that its relative error against the FDTD oracle is under
   1e-3;
5. the vector slice (--vector, m=8): the fused route at block width 1, K1,
   K2, K3 every step, no K4, K5 for every FDTD step;
6. the compensated slice (--compensated, m=6, p=4): the 3-call fused step
   with K7 for every Gram (m + 1 calls) and no K3 or K4.

Each slice phase sets the launch counts to 0 just before it drives the CLI
and reads them just after.

The FDTD oracle's forward-Euler error falls as 1/steps; the CLI's default
is 10^6 steps, the smoke takes 2000 to fit its time budget.

Output: one JSON line of per-kernel results (launches summed over the
three slices), the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

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
SOURCE = "lanczos_tpu_torch/csrc/lanczos_kernels.cu"
REPLACES = {
    "apply_stencil_pair": "lanczos_tpu/ops/pallas/stencil_kernel.py:70",
    "block_mix": "lanczos_tpu/ops/pallas/block_dense.py:104",
    "block_grams": "lanczos_tpu/ops/pallas/block_dense.py:210",
    "apply_stencil_pair_gram": "lanczos_tpu/ops/pallas/stencil_gram.py:96",
    "fdtd_step": "lanczos_tpu/ops/pallas/stencil_fdtd.py:50",
    "block_grams_compensated": "lanczos_tpu/ops/pallas/block_dense.py:361",
}


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
    # "stencil_gram_kernel<f,4>: 98 registers, 0 bytes spill stores"
    name, spills = None, ""
    for ln in build.build_log.splitlines():
        m = re.search(r"\d([a-z][a-z_]*_kernel)(?=[IE])(?:I([fd]+)(?:Li(\d+)E)?)?", ln)
        if "Compiling entry function" in ln and m:
            args = ",".join(a for a in m.group(2, 3) if a)
            name = f"{m.group(1)}<{args}>"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spills = m.group(0)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            log(f"  ptxas {name}: {m.group(1)} registers, {spills}")


def compare(torch, got, want, rtol):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-300)
    ok = math.isfinite(err) and err <= rtol * scale
    return err, err / scale, ok


def phase_kernels(torch, results, failures):
    """Each kernel against its plain version, at the slice's shapes (timed)
    and at a small odd geometry."""
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

    for n, p, dtype in ((N_SLICE, P_SLICE, torch.float32),
                        (11, 3, torch.float32), (11, 3, torch.float64)):
        dname = str(dtype).split(".")[-1]
        timed = n == N_SLICE
        log(f"kernels vs plain at N={n} p={p} {dname}")
        op = PallasMaxwellOperator.create(n, n, n, dtype=dtype, device=dev)
        shape = (p,) + op.state_shape
        g = torch.Generator(device=dev).manual_seed(0)

        def rand(rows=p):
            # unit-norm block columns, the scale of the Lanczos basis, so
            # the Grams are O(1) as on the main path
            x = torch.randn((rows,) + op.state_shape, generator=g,
                            device=dev, dtype=dtype)
            return x / x.flatten(1).norm(dim=1).view(-1, 1, 1, 1)

        state_bytes = math.prod(shape) * torch.tensor([], dtype=dtype).element_size()
        row = {}

        def record(name, label, got, want, kernel_fn, plain_fn, nbytes):
            err = check(label, name, dname, got, want)
            if not timed:
                return
            ms = cuda_ms(torch, kernel_fn)
            plain_ms = cuda_ms(torch, plain_fn)
            log(f"    {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"{nbytes / 1e6:.1f} MB/call -> {nbytes / ms / 1e6:.1f} GB/s")
            row.setdefault(name, dict(
                name=name, route="cuda", source=SOURCE,
                replaces=REPLACES[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms,
            ))

        if timed:
            src, dst = rand(), rand()
            copy_ms = cuda_ms(torch, lambda: dst.copy_(src))
            log(f"  device copy of one block state: {copy_ms:.4f} ms, "
                f"{2 * state_bytes / copy_ms / 1e6:.1f} GB/s (read + write)")
            del src, dst

        # K1, K2, K3 at the block width and, on the slice's geometry, at
        # p=1, the vector slice's fused route (K2 -> K1 -> K3 per step); the
        # JSON line keeps the block width's times
        for pk in (p, 1) if timed else (p,):
            tag = f" p={pk}"
            pbytes = state_bytes * pk // p

            # K1: A u
            u = rand(pk)
            plain_k1 = lambda: apply_stencil_pair_plain(  # noqa: E731
                u, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
            record("apply_stencil_pair", "K1 apply_stencil_pair" + tag, op.mm(u),
                   plain_k1(), lambda: op.mm(u), plain_k1, 2 * pbytes)
            del u

            # K2: block_mix, 1-, 2- and 3-operand, and in place (the mono
            # form is the one timed at p=4: it runs every step there; p=1
            # runs the 3-operand form into a new buffer)
            xs = [rand(pk) for _ in range(3)]
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
                               (k + 1) * pbytes)
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
                               (k + 1) * pbytes)
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
                   2 * pbytes)
            check("K3 block_grams (), b, include_zz" + tag, "block_grams", dname,
                  block_dense.block_grams((), q, include_zz=True),
                  block_dense.block_grams_plain((), q, include_zz=True))
            check("K3 block_grams (x0, x1, x2), z" + tag, "block_grams", dname,
                  block_dense.block_grams(tuple(xs), v),
                  block_dense.block_grams_plain(tuple(xs), v))
            del xs, q, v

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
               3 * state_bytes)
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
                   2 * state_bytes * pk // p)
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
                   2 * state_bytes)
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
        if timed:
            results["kernels"] = [row[k] for k in REPLACES]
        del op
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


def drive(torch, build, results, label, cfg):
    """One slice through the CLI's `run`, its launch counts read from 0."""
    from lanczos_tpu_torch.cli import run

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = run(cfg)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    results.setdefault("launches", {})[label] = launches
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

    results, failures = {}, []
    phases = (
        ("environment", lambda: phase_environment(torch, build)),
        ("build", lambda: phase_build(build)),
        ("kernels", lambda: phase_kernels(torch, results, failures)),
        ("block slice",
         lambda: phase_block_slice(torch, build, results, failures)),
        ("vector slice",
         lambda: phase_vector_slice(torch, build, results, failures)),
        ("compensated slice",
         lambda: phase_compensated_slice(torch, build, results, failures)),
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

    if failures or "kernels" not in results:
        for f in failures or ["no kernel results"]:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    paths = results.get("launches", {}).values()
    kernels = [r | {"launches": sum(c[r["name"]] for c in paths)}
               for r in results["kernels"]]
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
