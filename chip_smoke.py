#!/usr/bin/env python3
"""Smoke test of lanczos_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  Phases, each of which must pass:

1. environment: torch / CUDA / nvcc / triton versions, the card's name and
   power limit;
2. build: the four hand-written CUDA kernels (K1-K4) from
   lanczos_tpu_torch/csrc, with nvcc's register/spill report;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (Maxwell N=160, p=4) and at a small odd
   geometry (N=11, p=3, f32 and f64), with the tolerance stated below, and
   timed against its plain version and against a device copy of the same
   bytes;
4. the slice end to end through the CLI's `run`: N=160, m=6, p=4,
   --operator pallas, 2000 FDTD steps.  It checks that the main path went
   through all four kernels (the stencil_gram count equals m - 2: the fused
   mono step ran), that the solution is finite and that its relative error
   against the FDTD oracle is under 1e-3.

The FDTD oracle's forward-Euler error falls as 1/steps; the CLI's default
is 10^6 steps, the smoke takes 2000 to fit its time budget.

Output: one JSON line of per-kernel results, the nvidia-smi line, and as
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
FDTD_STEPS, LC = 2000, 20
REL_ERROR_BOUND = 1e-3  # as tests/test_cli.py
TIMED_LAUNCHES = 20
# kernel vs plain, relative to the plain result's largest |value|: the
# elementwise kernels (K1, K2) differ from torch only by FMA contraction;
# the Gram sums (K3, K4) add ~28M products in another order
KERNEL_RTOL = {"float32": 1e-5, "float64": 1e-12}
SOURCE = "lanczos_tpu_torch/csrc/lanczos_kernels.cu"
REPLACES = {
    "apply_stencil_pair": "lanczos_tpu/ops/pallas/stencil_kernel.py:70",
    "block_mix": "lanczos_tpu/ops/pallas/block_dense.py:104",
    "block_grams": "lanczos_tpu/ops/pallas/block_dense.py:210",
    "apply_stencil_pair_gram": "lanczos_tpu/ops/pallas/stencil_gram.py:96",
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
        m = re.search(r"\d([a-z_]+_kernel)I([fd])E?(?:Li(\d+)E)?", ln)
        if "Compiling entry function" in ln and m:
            name = f"{m.group(1)}<{m.group(2)}{',' + m.group(3) if m.group(3) else ''}>"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spills = m.group(0)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            log(f"  ptxas {name}: {m.group(1)} registers, {spills}")


def compare(torch, got, want, dtype_name):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-300)
    ok = math.isfinite(err) and err <= KERNEL_RTOL[dtype_name] * scale
    return err, err / scale, ok


def phase_kernels(torch, results, failures):
    """Each kernel against its plain version, at the slice's shapes (timed)
    and at a small odd geometry."""
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.ops.kernels import block_dense, stencil_gram
    from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
        apply_stencil_pair_plain,
    )

    dev = torch.device("cuda")

    def check(label, name, dtype_name, got, want):
        err, rel, ok = compare(torch, got, want, dtype_name)
        log(f"  {label}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {KERNEL_RTOL[dtype_name]:.0e}) {'ok' if ok else 'FAIL'}")
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

        # K1: A u
        u = rand()
        plain_k1 = lambda: apply_stencil_pair_plain(  # noqa: E731
            u, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
        record("apply_stencil_pair", "K1 apply_stencil_pair", op.mm(u),
               plain_k1(), lambda: op.mm(u), plain_k1, 2 * state_bytes)
        del u

        # K2: block_mix, 1-, 2- and 3-operand, and in place (the mono form
        # is the one timed into the JSON line: it runs every step)
        xs = [rand() for _ in range(3)]
        for k in (3, 1, 2):
            coeffs = 0.1 * torch.randn((k * p, p), generator=g, device=dev, dtype=dtype)
            ops = xs[:k]
            want = block_dense.block_mix_plain(coeffs, ops)
            if k == 3:
                work = [x.clone() for x in ops]
                got = block_dense.block_mix(coeffs, work, inplace=True)
                assert got.data_ptr() == work[0].data_ptr()
                record("block_mix", "K2 block_mix 3 operands in place", got, want,
                       lambda: block_dense.block_mix(coeffs, work, inplace=True),
                       lambda: block_dense.block_mix_plain(coeffs, ops),
                       (k + 1) * state_bytes)
                del work, got
                got = block_dense.block_mix(coeffs, ops)
                check("K2 block_mix 3 operands", "block_mix", dname, got, want)
            else:
                got = block_dense.block_mix(coeffs, ops)
                check(f"K2 block_mix {k} operand(s)", "block_mix", dname, got, want)
            del got, want

        # K3: block_grams with include_zz, as the prologue and peeled step
        q, v = xs[0], xs[1]
        record("block_grams", "K3 block_grams (q,), v, include_zz",
               block_dense.block_grams((q,), v, include_zz=True),
               block_dense.block_grams_plain((q,), v, include_zz=True),
               lambda: block_dense.block_grams((q,), v, include_zz=True),
               lambda: block_dense.block_grams_plain((q,), v, include_zz=True),
               2 * state_bytes)
        check("K3 block_grams (), b, include_zz", "block_grams", dname,
              block_dense.block_grams((), q, include_zz=True),
              block_dense.block_grams_plain((), q, include_zz=True))
        check("K3 block_grams (x0, x1, x2), z", "block_grams", dname,
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
        if timed:
            results["kernels"] = [row[k] for k in REPLACES]
        del op
        torch.cuda.empty_cache()


def phase_slice(torch, build, results, failures):
    from lanczos_tpu_torch.cli import run
    from lanczos_tpu_torch.config import LanczosConfig
    from lanczos_tpu_torch.methods.expm_action import block_lanczos_expm_action
    from lanczos_tpu_torch.methods.fdtd import fdtd_block
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B

    cfg = LanczosConfig(n_grid=N_SLICE, m=M_SLICE, n_col=P_SLICE,
                        operator="pallas", fdtd_steps=FDTD_STEPS, lc=LC,
                        device="cuda")
    log(f"slice: python -m lanczos_tpu_torch -N {N_SLICE} -m {M_SLICE} "
        f"--block --n-col {P_SLICE} --operator pallas --fdtd-steps "
        f"{FDTD_STEPS} --lc {LC}")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = run(cfg)
    launches = dict(build.LAUNCHES)
    results["launches"] = launches
    log(f"  launches: {launches}")
    log(f"  n {out['n']} lc {out['lc']} solution {out['solution']}")
    log(f"  relative_error {out['relative_error']:.6e} (bound {REL_ERROR_BOUND:g})")
    log(f"  lanczos_seconds {out['lanczos_seconds']:.3f} (fixture + pack + "
        f"Lanczos + expm), fdtd_seconds {out['fdtd_seconds']:.3f}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if any(v <= 0 for v in launches.values()):
        failures.append(f"a kernel of the path never launched: {launches}")
    if launches["apply_stencil_pair_gram"] != M_SLICE - 2:
        failures.append("stencil_gram launches != m - 2: the mono step did not run")
    sol = out["solution"]
    if len(sol) != P_SLICE or not all(math.isfinite(x) for x in sol):
        failures.append(f"solution not finite / not of length p: {sol}")
    if not out["relative_error"] < REL_ERROR_BOUND:
        failures.append(f"relative_error {out['relative_error']} >= {REL_ERROR_BOUND}")

    # steady-state device times of the two halves, with CUDA events
    dev = torch.device("cuda")
    op = PallasMaxwellOperator.create(N_SLICE, N_SLICE, N_SLICE, device=dev)
    b_np = gaussian_matrix_B(N_SLICE, op.n, P_SLICE).astype("float32")
    b = op.pack(torch.from_numpy(b_np).to(dev))
    del b_np
    tf = op.trace_fn(LC)
    lanczos_ms = cuda_ms(torch, lambda: block_lanczos_expm_action(
        op, b, M_SLICE, 1.0, 0, trace_fn=tf), iters=3, warmup=1)
    a_dt = op.scaled(torch.tensor(1.0 / FDTD_STEPS))
    u = b.clone()
    step_ms = cuda_ms(torch, lambda: u.add_(a_dt.mm(u)), iters=100, warmup=5)
    fdtd_ms = cuda_ms(torch, lambda: fdtd_block(op, b, 50, 1.0), iters=1,
                      warmup=0) / 50
    log(f"  lanczos (m={M_SLICE}) + expm: {lanczos_ms:.3f} ms, "
        f"{lanczos_ms / M_SLICE:.3f} ms/iteration")
    log(f"  fdtd: {step_ms:.4f} ms/step (K1 + add), {fdtd_ms:.4f} ms/step "
        "through fdtd_block")


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
        ("slice", lambda: phase_slice(torch, build, results, failures)),
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
    kernels = [r | {"launches": results["launches"][r["name"]]}
               for r in results["kernels"]]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
