"""Timing probes of the port on one CUDA card, beyond `chip_smoke.py`.

    python -m lanczos_tpu_torch.probes
    python -m lanczos_tpu_torch.probes --p1-variants
    python -m lanczos_tpu_torch.probes --assembled

At the slice of `chip_smoke.py` (Maxwell N=160, m=6, p=4, receiver 20,
f32), prints the card's name and power limit, then:

1. sqrtm + inverse sqrtm of a p x p SPD matrix per eig backend (jacobi,
   newton, lax) at p = 4, 8, 16: host ms per call after a synchronise,
   mean of 10 calls after 3 warm-up calls.  This algebra is launch-bound,
   so the host clock is its cost.
2. `block_lanczos_expm_action` on the Maxwell fixture per eig backend, fused and materialized (--no-fused): ms per iteration (CUDA
   events around one run; after a warm-up run of each, three rounds that
   visit every configuration in turn, so drift of the host's speed falls
   on all of them alike), the median and each round, and peak device
   memory.
3. `torch.profiler` traces of one default block run (fused, jacobi), one
   vector run (`--vector`, m=8, the fused route at p=1), one compensated
   block run, and 50 FDTD steps at p=4 and at p=1 (K5): device time per
   kernel, and the device's idle share, 1 - device / wall, with the wall
   time of an untraced run (the profiler slows the host).

With --p1-variants it prints only this, the probe behind the shape of the
stencil body's component loop: K1 and K5 at p=1 and K5 at p=4 (N=160,
f32), each built from a variant of `csrc/lanczos_kernels.cu` (the loop over
the six components rolled, as the source stands; unrolled by 2, 3 or fully;
and p=1 on the four-column instantiation), with each variant's registers
from `-Xptxas -v` and its largest difference from the source's K5 p=1
result.  Device ms per call (CUDA events, 50 calls after 3 warm-up calls),
two rounds over all variants so that drift falls on all alike.

With --assembled it prints only this, the breakdown of the assembled
slice of `chip_smoke.py`: the host seconds to build the 10,485,760-row
synthetic matrix and to plan it, then `torch.profiler` traces (as in 3.)
of one `block_lanczos_eigsh` run on its padded windowed operator (p=8,
m=12, k=5, reorth full, TSQR, breakdown_eps 1e-4, replace_dead,
compute_vectors) and of 50 FDTD steps of the ELL slice's operator
(`--operator ell`, N=48, p=4).
"""

from __future__ import annotations

import re
import subprocess
import sys
import time

import torch

from lanczos_tpu_torch.methods.expm_action import (
    block_lanczos_expm_action,
    lanczos_expm_action,
)
from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.models.rhs import gaussian_matrix_B, gaussian_vector_b
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.smalleig import sqrtm_invsqrtm

BACKENDS = ("jacobi", "newton", "lax")
N, M, P, LC = 160, 6, 4, 20
M_VECTOR, FDTD_STEPS = 8, 50
ROUNDS = 3


def probe_sqrtm(dev) -> None:
    for p in (4, 8, 16):
        g = torch.Generator(device=dev).manual_seed(p)
        a = torch.randn((p, p), generator=g, device=dev)
        a = a @ a.T + p * torch.eye(p, device=dev)
        for be in BACKENDS:
            for _ in range(3):
                sqrtm_invsqrtm(a, backend=be)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                sqrtm_invsqrtm(a, backend=be)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / 10 * 1e3
            print(f"sqrtm p={p} {be}: {ms:.3f} ms/call (host clock)", flush=True)


def probe_slice(op, b, m, tf) -> None:
    dev = b.device
    configs = [(be, fused) for be in BACKENDS for fused in (True, False)]

    def once(be, fused):
        return block_lanczos_expm_action(op, b, m, 1.0, 0, trace_fn=tf,
                                         eig_backend=be, fused=fused)

    ms, peak, sols = {c: [] for c in configs}, {}, {}
    for c in configs:
        once(*c)
    for _ in range(ROUNDS):
        for c in configs:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sols[c] = once(*c)
            end.record()
            torch.cuda.synchronize(dev)
            ms[c].append(start.elapsed_time(end) / m)
            peak[c] = torch.cuda.max_memory_allocated(dev) / 2**30
    for be, fused in configs:
        t = ms[be, fused]
        print(f"slice m={m} eig={be} fused={fused}: median "
              f"{sorted(t)[len(t) // 2]:.3f} ms/iteration (rounds "
              f"{', '.join(f'{x:.3f}' for x in t)}), peak "
              f"{peak[be, fused]:.2f} GiB, solution "
              f"{sols[be, fused].tolist()}", flush=True)


def probe_profile(label, run_once, dev) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed_run():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    timed_run()
    wall_ms = timed_run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = timed_run()
    ka = prof.key_averages()
    # kernel rows only: an aten row repeats its kernels' device time
    device_ms = sum(e.self_device_time_total for e in ka
                    if e.device_type != DeviceType.CPU) / 1e3
    print(ka.table(sort_by="self_device_time_total", row_limit=14,
                   max_name_column_width=48))
    if device_ms > 0:
        print(f"profile {label}: device {device_ms:.3f} ms, wall {wall_ms:.3f} ms "
              f"untraced ({traced_ms:.3f} traced), device idle "
              f"{1 - device_ms / wall_ms:.1%}", flush=True)
    else:
        print(f"profile {label}: wall {wall_ms:.3f} ms, device time not measured "
              "(the trace holds no device events)", flush=True)


def _p1_variants(src: str) -> dict[str, str]:
    rolled = "#pragma unroll 1\n    for (int c = 0; c < 6; ++c)"
    to_p4 = {f"p == 1 ? {k}<T, 1>": f"p == 0 ? {k}<T, 1>"
             for k in ("stencil_pair_kernel", "fdtd_step_kernel")}
    if src.count(rolled) != 1 or any(src.count(k) != 1 for k in to_p4):
        raise RuntimeError("the kernel source no longer has the shape the "
                           "p=1 variants edit")
    out = {"rolled": src}
    for n, pragma in (("2", "#pragma unroll 2"), ("3", "#pragma unroll 3"),
                      ("full", "#pragma unroll")):
        out[f"unroll {n}"] = src.replace(rolled, rolled.replace(
            "#pragma unroll 1", pragma))
    cols4 = src
    for old, new in to_p4.items():
        cols4 = cols4.replace(old, new)
    out["p=1 on 4 columns"] = cols4
    # a line of its own makes each variant a build of its own, so its
    # registers are in the build log
    return {name: f"// p=1 variant: {name}\n{text}" for name, text in out.items()}


def _stencil_registers(log: str) -> str:
    """Registers of the f32 instantiations the p=1 variants time."""
    timed = {"stencil_pair_kernel<f,1>", "fdtd_step_kernel<f,1>",
             "fdtd_step_kernel<f,4>"}
    regs, name = [], None
    for ln in log.splitlines():
        m = re.search(r"(stencil_pair_kernel|fdtd_step_kernel)I([fd])Li(\d)E", ln)
        if "Compiling entry function" in ln:
            name = f"{m.group(1)}<{m.group(2)},{m.group(3)}>" if m else None
        m = re.search(r"Used (\d+) registers", ln)
        if m and name in timed:
            regs.append(f"{name} {m.group(1)}")
    return ", ".join(regs)


def probe_p1_variants(dev) -> None:
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    a_dt = op.scaled(1.0 / FDTD_STEPS)
    g = torch.Generator(device=dev).manual_seed(0)
    u1 = torch.randn((1,) + op.state_shape, generator=g, device=dev)
    u4 = torch.randn((P,) + op.state_shape, generator=g, device=dev)
    out1, out4 = torch.empty_like(u1), torch.empty_like(u4)

    def ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters

    source, ref, regs = build.SOURCE, None, {}
    variants = _p1_variants(source.read_text())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        for rnd in range(2):
            for name, text in variants.items():
                path = build.BUILD_DIR / f"p1_variant_{name.replace(' ', '_')}.cu"
                path.write_text(text)
                build.SOURCE, build._lib = path, None
                build.library()
                # the log is the last nvcc run's: round 0 builds each variant
                regs.setdefault(name, _stencil_registers(build.build_log))
                got = a_dt.fdtd_step(u1, out1).clone()
                ref = got if ref is None else ref
                print(f"round {rnd} {name}: K5 p=1 "
                      f"{ms(lambda: a_dt.fdtd_step(u1, out1)):.4f} ms, K1 p=1 "
                      f"{ms(lambda: op.mm(u1)):.4f} ms, K5 p={P} "
                      f"{ms(lambda: a_dt.fdtd_step(u4, out4)):.4f} ms, max diff "
                      f"{(got - ref).abs().max().item():.1e}; registers {regs[name]}",
                      flush=True)
    finally:
        build.SOURCE, build._lib = source, None


def probe_assembled(dev) -> None:
    import numpy as np

    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh
    from lanczos_tpu_torch.models.maxwell import maxwell_ell_operator
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.window_ell import (
        PaddedWindowedOperator,
        windowed_from_scipy,
    )

    t0 = time.perf_counter()
    a = synth_suitesparse_banded(10_485_760)
    t1 = time.perf_counter()
    A = windowed_from_scipy(a, reorder="none", device=dev)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    print(f"assembled: build {t1 - t0:.2f} s, plan {t2 - t1:.2f} s (host), "
          f"ppc {A.ppc}, {a.nnz} nnz", flush=True)
    op = PaddedWindowedOperator(A)
    x = np.random.default_rng(0).standard_normal((8, a.shape[0]), np.float32)
    b = A.pack(torch.from_numpy(x).to(dev))
    del a, x
    probe_profile("assembled eigsh p=8 m=12", lambda: block_lanczos_eigsh(
        op, b, 12, 5, reorth="full", normalize="qr", breakdown_eps=1e-4,
        replace_dead=True, eig_backend="newton", compute_vectors=True), dev)
    del op, A, b
    ell = maxwell_ell_operator(48, 48, 48, device=dev)
    u = torch.randn((P, ell.shape[0]), device=dev)
    probe_profile(f"ell fdtd p={P} {FDTD_STEPS} steps",
                  lambda: fdtd_block(ell, u, FDTD_STEPS, 1.0), dev)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time the CUDA card: none is available")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if "--p1-variants" in sys.argv[1:]:
        probe_p1_variants(dev)
        return
    if "--assembled" in sys.argv[1:]:
        probe_assembled(dev)
        return
    probe_sqrtm(dev)
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    b_np = gaussian_matrix_B(N, op.n, P).astype("float32")
    b = op.pack(torch.from_numpy(b_np).to(dev))
    del b_np
    tf = op.trace_fn(LC)
    probe_slice(op, b, M, tf)
    probe_profile(f"block m={M}", lambda: block_lanczos_expm_action(
        op, b, M, 1.0, 0, trace_fn=tf), dev)
    probe_profile(f"compensated m={M}", lambda: block_lanczos_expm_action(
        op, b, M, 1.0, 0, trace_fn=tf, compensated=True), dev)
    bv = op.pack(torch.from_numpy(gaussian_vector_b(N, op.n).astype("float32")).to(dev))
    probe_profile(f"vector m={M_VECTOR}", lambda: lanczos_expm_action(
        op, bv, M_VECTOR, 1.0, 0, trace_fn=tf), dev)
    probe_profile(f"fdtd p={P} {FDTD_STEPS} steps",
                  lambda: fdtd_block(op, b, FDTD_STEPS, 1.0), dev)
    probe_profile(f"fdtd p=1 {FDTD_STEPS} steps",
                  lambda: fdtd_vector(op, bv, FDTD_STEPS, 1.0), dev)


if __name__ == "__main__":
    main()
