"""Timing probes of the port on one CUDA card, beyond `chip_smoke.py`.

    python -m lanczos_tpu_torch.probes
    python -m lanczos_tpu_torch.probes --stencil-tiles
    python -m lanczos_tpu_torch.probes --stencil-parts [--source OLD.cu]
    python -m lanczos_tpu_torch.probes --assembled
    python -m lanczos_tpu_torch.probes --ab OLD.cu
    python -m lanczos_tpu_torch.probes --gram-tiles
    python -m lanczos_tpu_torch.probes --dist-ell
    python -m lanczos_tpu_torch.probes --dist-windowed
    python -m lanczos_tpu_torch.probes --fdtd-graph
    python -m lanczos_tpu_torch.probes --tsqr
    python -m lanczos_tpu_torch.probes --cgs2

At the slice of `chip_smoke.py` (Maxwell N=160, m=6, p=4, receiver 20,
f32), prints the card's name and power limit, then:

1. sqrtm + inverse sqrtm of a p x p SPD matrix per eig backend (jacobi:
   S1, newton, lax) and S1's plain version at p = 4, 8, 16: host ms per
   call after a synchronise, mean of 10 calls after 3 warm-up calls.
   This algebra is launch- or latency-bound, so the host clock is its
   cost.
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

With --stencil-tiles it prints only this: K1 and K5 at p=1 and p=4 on
N=160 (f32), each on the plan `stencil_kernel.stencil_plan` picks and on
its neighbours (half and twice the strip width, each with the z-chunk the
plan picks for it; one z-chunk more and one fewer at the picked width),
then K4 at p=4 on `stencil_kernel.pair_gram_plan`'s pick and its
neighbours (one z-chunk more and one fewer, half the columns a staged
tile), timed in turns (picked, other, other, picked; CUDA events, 20 calls
after 2 warm-up calls), with each plan's blocks an SM by the occupancy
calculator and its shared memory.

With --assembled it prints only this, the breakdown of the assembled
slice of `chip_smoke.py`: the host seconds to build the 10,485,760-row
synthetic matrix and to plan it, then `torch.profiler` traces (as in 3.)
of one `block_lanczos_eigsh` run on its padded windowed operator (p=8,
m=12, k=5, reorth full, TSQR, breakdown_eps 1e-4, replace_dead,
compute_vectors) and of 50 FDTD steps of the ELL slice's operator
(`--operator ell`, N=48, p=4).

With --stencil-parts it prints only this: K1 and K5 at p=1 and p=4, K4 at
p=4 (f32) and K1 on bf16 states at p=8 and p=1, on N=160, built from
`csrc/lanczos_kernels.cu` (or OLD.cu, another commit's) as it stands and
with one part of the work cut out: the strip body's taps (each output is
0 for K1, u for K5: staging, barriers and stores only), its staging copies
(the taps read whatever the ring holds), its z-weight loads (each row's
z-weights read as 1), K4's Gram sums, K4's staging copies; every part's
library built at once (nvcc in threads), each timed as above, to show
which part sets the time.  An edit OLD.cu lacks is left out, and said so.

With --ab OLD.cu it prints only this, a same-call A/B of the kernels the
parent commit redesigned: OLD.cu is its `csrc/lanczos_kernels.cu` (`git
show 06798f8:lanczos_tpu_torch/csrc/lanczos_kernels.cu`), built and loaded
beside the current library with its C interface (`_OLD_SIGNATURES`).  K2
with 3 operands at N=160 (f32 p=4 in place, f32 p=1, bf16 p=1 and p=4,
f64 p=4, f32 p=8 on the runtime-K kernel; a new buffer but the first), K1
on bf16 states at p=8, p=4 and p=1, and as controls, unchanged, K1 and K5
(f32) at p=4 and p=1 and K4 at p=4: each timed old, new, new, old (CUDA
events, 20 calls after 2 warm-up calls), with the largest difference
between the two results (K4: g3, and v apart).

With --gram-tiles it prints only this: K3 at the fused recurrence's calls
(`(), b` and `(q,), v`, include_zz: K = p and 2p) at p=1 and p=4, and K7 at
p=4, on N=160 Maxwell-sized states (f32), each on the register tile
`block_dense.gram_tile` picks and on the 12 x 4 tile, timed in turns
(picked, 12 x 4, 12 x 4, picked).

With --dist-ell it prints only this, the row-sharded ELL operators on the
assembled slice's 10,485,760-row matrix (p=8, f32) at each mesh size d in
1, 2, 4 that the machine has cards for (one rank a card, NCCL): a rank's
`HaloShardedEll` and `GatherShardedEll` product, exchange included (CUDA
events, 20 calls after 2 warm-up calls, every rank timing the same
chain), the eigsh of the assembled slice on `HaloShardedEll` (wall
seconds and its Ritz values) and each rank's host seconds to build the
matrix and its shard.

With --dist-windowed it prints only this, the same for the row-sharded
windowed-ELL operator (`HaloShardedWindowed`, K8 on every rank's shard):
at each d, per rank, the host seconds to build the matrix and to plan its
shard, its plan (ppc, wsz, n128), a product at p=8 (exchange, work copy
and K8), and apart from it K8 alone on the rank's state and a device copy
of that state (the work copy's cost), timed as above; then the assembled
eigsh on it (wall seconds, Ritz values, measured residuals).

With --fdtd-graph it prints only this: FDTD's K5 loop (`euler_steps`) on
the convergence oracle's N=3 f64 p=1 state for 10^5 steps and on N=160
f32 p=4 for 2000 steps, eager and replayed from CUDA graphs of each chunk
in FDTD_CHUNKS steps (`fdtd.GRAPH_CHUNK` set for the run), each timed by
the host clock around a run that ends in a synchronise, in turns (eager,
chunks ascending, chunks descending, eager), with the largest difference
from the eager result (every one must read 0).

With --tsqr it prints only this: T1 (`ops/kernels/tsqr.py`) on random
(p, 10,485,760) block-major states, the assembled eigsh's (f32 p = 8),
and f32 p = 4, p = 16, f64 p = 8: a whole call, an R-only call, T1's plain
version and `library_tsqr` (the batched `torch.linalg.qr` tree T1
replaced), timed by CUDA events (20 calls after 2 warm-up calls; the plain
version and the library 3), with the bytes a call must move (3 S: the
block read twice and q written; S for R alone), their bound at 3.35 TB/s
and at the 2,987.6 GB/s copy rate, each launch's device time from a
`torch.profiler` trace of one call, and the factors' errors beside the
library's (||A - QR|| / ||A||, max |Q^T Q - I|); then at f32 p = 8 the
tiles of 512 and 256 rows against the plan's, in turns.

With --cgs2 it prints only this: C1 (`ops/kernels/cgs2.py`) on random
(p, 10,485,760) blocks against b stored blocks, at the assembled eigsh's
f32 p = 8 for every b its request runs (1..12) and at b = 12 in f32 p =
4, p = 16 and f64 p = 8: a call and its plain version `cgs2_plain` (the
two torch.mm passes it replaced, op for op), timed by CUDA events in turns
(kernel, plain, plain, kernel; 10 calls after 2 warm-up calls), with
the least bytes a CGS2 call moves ((3b + 4) S, S one block), their bound
at 3.35 TB/s and at the 2,987.6 GB/s copy rate, the bytes C1's schedule
moves ((3b + 5) S; A / C / A / C in chunks (4b + 6 chunks) S) and the
plain version's ((4b + 10) S), and each launch's device time from a
`torch.profiler` trace of one call; then the sums over the eigsh
request's 22 calls (b = 1..11 and 2..12).
"""

from __future__ import annotations

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
ASSEMBLED_ROWS, ASSEMBLED_P = 10_485_760, 8  # chip_smoke.py's assembled slice


def probe_sqrtm(dev) -> None:
    from lanczos_tpu_torch.ops.kernels.smalleig import jacobi_sqrtm_plain

    for p in (4, 8, 16):
        g = torch.Generator(device=dev).manual_seed(p)
        a = torch.randn((p, p), generator=g, device=dev)
        a = a @ a.T + p * torch.eye(p, device=dev)
        calls = {be: (lambda be=be: sqrtm_invsqrtm(a, backend=be)) for be in BACKENDS}
        calls["jacobi plain"] = lambda: jacobi_sqrtm_plain(a)
        for name, call in calls.items():
            for _ in range(3):
                call()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                call()
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / 10 * 1e3
            print(f"sqrtm p={p} {name}: {ms:.3f} ms/call (host clock)", flush=True)


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


def _ms(fn, iters=20, warmup=2) -> float:
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


# the parent's C interface (commit 06798f8, `git show 06798f8:lanczos_tpu_
# torch/csrc/lanczos_kernels.cu`): the current one, but K2's, which took no
# instantiation or vector width and a grid of at most 1024 blocks
_OLD_SIGNATURES = dict(
    build._SIGNATURES,
    lt_block_mix=build._SIGNATURES["lt_block_mix"][:11] + build._SIGNATURES[
        "lt_block_mix"][13:],
)
del _OLD_SIGNATURES["lt_mix_blocks_per_sm"]


def _old_library(path: str):
    """The kernels of the source at `path`, built beside the current ones
    and loaded with the parent's C interface."""
    from pathlib import Path

    return build.load(build.build(Path(path).resolve()), _OLD_SIGNATURES)


def _on(lib, fn):
    """fn() with every wrapper launching from `lib`."""
    def run():
        current = build._lib
        build._lib = lib
        try:
            return fn()
        finally:
            build._lib = current
    return run


def _ab(label, old_fn, new_fn, names=("old", "new")) -> None:
    """old, new, new, old; each call leaves its result in a buffer of its
    own, compared after the first round."""
    got_old, got_new = old_fn(), new_fn()
    torch.cuda.synchronize()
    diff = (got_old.double() - got_new.double()).abs().max().item()
    t = [_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
    a, b = names
    print(f"ab {label}: {a} {t[0]:.4f} {t[3]:.4f}, {b} {t[1]:.4f} {t[2]:.4f} "
          f"ms (means {a} {(t[0] + t[3]) / 2:.4f}, {b} {(t[1] + t[2]) / 2:.4f}); "
          f"max |{a} - {b}| {diff:.3e}", flush=True)


def probe_ab(dev, old_path: str) -> None:
    """K2 and K1 bf16 (redesigned) and K1/K5 f32 and K4 (unchanged: the
    A/B's spread) from the parent's source against the current ones."""
    from lanczos_tpu_torch.ops.kernels import block_dense

    old = _old_library(old_path)
    new = build.library()
    st = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    S = 6 * 176 * 26624  # one block column of the N=160 state

    def old_mix(coeffs, xs, out):
        """The parent's K2 as its wrapper launched it."""
        cf = coeffs.to(block_dense.acc_dtype(out.dtype)).contiguous()
        ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
        rows = [x.shape[0] for x in xs] + [0] * (3 - len(xs))

        def run():
            build.check(old.lt_block_mix(
                build.dtype_code(out, True), ptrs[0], rows[0], ptrs[1], rows[1],
                ptrs[2], rows[2], cf.data_ptr(), out.data_ptr(), out.shape[0], S,
                max(1, min(-(-S // 256), 1024)), st), "lt_block_mix")
            return out
        return run

    # K2: 3 operands (K = 3p) into p columns, as the mono step (in place) and
    # the 3-call step and the vector route (a new buffer) call it; p=8 takes
    # the runtime-K kernel
    for dtype, p, inplace in ((torch.float32, 4, True), (torch.float32, 1, False),
                              (torch.bfloat16, 1, False), (torch.bfloat16, 4, False),
                              (torch.float64, 4, False), (torch.float32, 8, False)):
        xs = [torch.randn((p, S), generator=g, device=dev).to(dtype)
              for _ in range(3)]
        coeffs = 0.1 * torch.randn((3 * p, p), generator=g, device=dev,
                                   dtype=block_dense.acc_dtype(dtype))
        name = f"K2 block_mix {str(dtype)[6:]} p={p}"
        if inplace:
            xo, xn = [x.clone() for x in xs], [x.clone() for x in xs]
            _ab(name + " in place", old_mix(coeffs, xo, xo[0]),
                lambda: block_dense.block_mix(coeffs, xn, inplace=True))
            del xo, xn
        else:
            out = torch.empty_like(xs[0])
            _ab(name, old_mix(coeffs, xs, out),
                lambda: block_dense.block_mix(coeffs, xs))
            del out
        del xs
        torch.cuda.empty_cache()
    # K1 on bf16 states (redesigned), then the f32 controls: K1, K5, K4
    for dtype, ps in ((torch.bfloat16, (8, P, 1)), (torch.float32, (P, 1))):
        op = PallasMaxwellOperator.create(N, N, N, dtype=dtype, device=dev)
        for p in ps:
            u = torch.randn((p,) + op.state_shape, generator=g, device=dev).to(dtype)
            _ab(f"K1 apply_stencil_pair {str(dtype)[6:]} p={p}",
                _on(old, lambda: op.mm(u)), _on(new, lambda: op.mm(u)))
            if dtype == torch.float32:
                a_dt = op.scaled(1.0 / FDTD_STEPS)
                outs = [torch.empty_like(u) for _ in range(2)]
                _ab(f"K5 fdtd_step p={p}", _on(old, lambda: a_dt.fdtd_step(u, outs[0])),
                    _on(new, lambda: a_dt.fdtd_step(u, outs[1])))
                del outs
            if dtype == torch.float32 and p == P:
                dst_old, dst_new = torch.empty_like(u), torch.empty_like(u)
                _ab(f"K4 apply_stencil_pair_gram p={P} (g3)",
                    _on(old, lambda: op.stencil_gram(u, dst_old)[1]),
                    _on(new, lambda: op.stencil_gram(u, dst_new)[1]))
                torch.cuda.synchronize()
                print(f"ab K4 apply_stencil_pair_gram p={P}: max |old v - new v| "
                      f"{(dst_old - dst_new).abs().max().item():.3e}", flush=True)
                del dst_old, dst_new
            del u
        del op
        torch.cuda.empty_cache()


def _neighbour_plans(picked, plan):
    """The plans beside `picked` that the kernel can run: half and twice
    its strip width (each with the z-chunk the plan picks for it), and one
    z-chunk more and one fewer at its width."""
    zc = picked.zchunk * picked.chunks
    kws = [dict(width=picked.width // 2), dict(width=2 * picked.width),
           dict(width=picked.width, zchunk=-(-zc // (picked.chunks + 1)))]
    if picked.chunks > 1:
        kws.append(dict(width=picked.width, zchunk=-(-zc // (picked.chunks - 1))))
    out = []
    for kw in kws:
        try:
            out.append(plan(**kw))
        except ValueError:  # no such strip (over two lanes a thread)
            pass
    return out


# string edits of the stencil kernels that drop one part of their work: the
# K1/K5 strip body's taps (and K1's on bf16 states, stencil_row_curl), its
# staging copies or its z-weight loads, K4's Gram sums or staging
_STENCIL_PARTS = {
    "as built": (),
    "K1/K5 no taps": ((
        "        if (a.paired[h]) {\n#pragma unroll\n"
        "          for (int k = 0; k + 1 < kMaxTaps; k += 2) {\n"
        "            if (k + 1 >= a.n[c]) break;\n            // the pair's",
        "        if (true) {} else if (a.paired[h]) {\n#pragma unroll\n"
        "          for (int k = 0; k + 1 < kMaxTaps; k += 2) {\n"
        "            if (k + 1 >= a.n[c]) break;\n            // the pair's"), (
        "    for (int k = 0; k < kMaxTaps; k += 2) {\n      const float2 t0 = pair(k)",
        "    for (int k = 0; k < 0; k += 2) {\n      const float2 t0 = pair(k)")),
    "K1/K5 no staging": (("                cp_async16(slot",
                          "                if (false) cp_async16(slot"),),
    "K1/K5 no z-weight loads": ((
        "            wcol >= 0 ? __ldg(wz + ((long long)wh * a.zc + z) * a.nt + wcol)\n"
        "                      : W(0);",
        "            W(wcol >= 0);"), (
        "          wnext = wcol >= 0 ? __ldg(wz + ((long long)wh * a.zc + zn) * a.nt + wcol)\n"
        "                            : W(0);",
        "          wnext = W(wcol >= 0);")),
    "K4 no Gram": (("            if (!TILED || in_tile(j)) {",
                    "            if (false) {"),
                   ("            if (!TILED || in_tile(k))\n",
                    "            if (false)\n")),
    "K4 no staging": (("          cp_async16(sb + (i + k * kThreads)",
                       "          if (false) cp_async16(sb + (i + k * kThreads)"),
                      ("          cp_async16(db + bb * dcol",
                       "          if (false) cp_async16(db + bb * dcol")),
}
P_BF16 = (8, 1)  # K1 on bf16 states: chip_smoke.py's row and the vector route


def _edit_parts(text: str, strict: bool) -> dict:
    """Each part's source: `text` with the part's edits made.  An edit must
    match once; with strict=False (another commit's source) an edit that
    matches nowhere is left out, and said so."""
    parts = {}
    for name, edits in _STENCIL_PARTS.items():
        part = text
        for old, new in edits:
            n = part.count(old)
            if n == 0 and not strict:
                print(f"stencil part {name}: the source has no {old[:40]!r}..., "
                      "left out", flush=True)
                continue
            if n != 1:
                raise RuntimeError(f"the kernel source has {n} of {old!r}")
            part = part.replace(old, new)
        parts[name] = part
    return parts


def probe_stencil_parts(dev, source=None) -> None:
    """Times each part of `_STENCIL_PARTS` made of `source` (default the
    repo's kernel source; another is the parent's, with its C interface),
    every part's library built at once."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    op16 = PallasMaxwellOperator.create(N, N, N, dtype=torch.bfloat16, device=dev)
    a_dt = op.scaled(1.0 / FDTD_STEPS)
    g = torch.Generator(device=dev).manual_seed(0)
    us = {p: torch.randn((p,) + op.state_shape, generator=g, device=dev)
          for p in (1, P)}
    us16 = {p: torch.randn((p,) + op.state_shape, generator=g, device=dev).to(
        torch.bfloat16) for p in P_BF16}
    outs = {p: torch.empty_like(u) for p, u in us.items()}
    q, dst = us[P], torch.empty_like(us[P])
    path = build.SOURCE if source is None else Path(source)
    parts = _edit_parts(path.read_text(), strict=source is None)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, part in parts.items():
        tag = name.replace(" ", "_").replace("/", "")
        paths.append(build.BUILD_DIR / f"stencil_part_{tag}.cu")
        # a line of its own makes each part a build of its own
        paths[-1].write_text(f"// stencil part: {name} of {path.name}\n" + part)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = list(pool.map(build.build, paths))
    print(f"stencil parts of {path}: {len(libs)} builds at once, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        for name, lib in zip(parts, libs):
            build._lib = build.load(lib, None if source is None else _OLD_SIGNATURES)
            times = []
            for p in (1, P):
                u, out = us[p], outs[p]
                times.append(f"K1 p={p} {_ms(lambda: op.mm(u)):.4f} ms, K5 p={p} "
                             f"{_ms(lambda: a_dt.fdtd_step(u, out)):.4f} ms")
            times.append(f"K4 p={P} {_ms(lambda: op.stencil_gram(q, dst)):.4f} ms")
            times += [f"K1 bf16 p={p} {_ms(lambda: op16.mm(us16[p])):.4f} ms"
                      for p in P_BF16]
            print(f"stencil part {name}: " + ", ".join(times), flush=True)
    finally:
        build._lib = None


def probe_stencil_tiles(dev) -> None:
    from lanczos_tpu_torch.ops.kernels import stencil_kernel as sk

    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    a_dt = op.scaled(1.0 / FDTD_STEPS)
    left, right = sk.stencil_halos(op.spec_e, op.spec_h)
    zc, plane = op.spec.zc, op.spec.plane
    sms = build.sm_count(dev)
    picked_fn = sk.pair_plan
    g = torch.Generator(device=dev).manual_seed(0)
    for p in (1, P):
        u = torch.randn((p,) + op.state_shape, generator=g, device=dev)
        out, out2 = torch.empty_like(u), torch.empty_like(u)
        picked = picked_fn(op.spec_e, op.spec_h, p, 4, sms)

        others = _neighbour_plans(
            picked, lambda **kw: sk.stencil_plan(zc, plane, left, right, p, 4,
                                                 sms, **kw))

        def name(pl):
            occ = [build.library().lt_stencil_blocks_per_sm(
                0, k, pl.lanes_per_thread, pl.smem_bytes) for k in (0, 1)]
            return (f"W{pl.width}xZ{pl.zchunk} ({pl.strips}x{pl.chunks} blocks, "
                    f"{pl.smem_bytes} B, K1/K5 {occ[0]}/{occ[1]} a SM)")

        def on(pl, fn):
            sk.pair_plan = lambda *args: pl
            try:
                return fn()
            finally:
                sk.pair_plan = picked_fn
        for other in others:
            names = (name(picked), name(other))
            _ab(f"K1 p={p}", lambda: on(picked, lambda: op.mm(u)),
                lambda: on(other, lambda: op.mm(u)), names=names)
            _ab(f"K5 p={p}", lambda: on(picked, lambda: a_dt.fdtd_step(u, out)),
                lambda: on(other, lambda: a_dt.fdtd_step(u, out2)), names=names)
        del u, out, out2
    probe_gram_strip_tiles(dev, op)
    torch.cuda.empty_cache()


def probe_gram_strip_tiles(dev, op) -> None:
    """K4 at p=P on the plan `stencil_kernel.pair_gram_plan` picks against
    its neighbours: one z-chunk more and one fewer, and half the columns a
    staged tile (the tiled form the plan takes where a ring of every
    column does not fit)."""
    from lanczos_tpu_torch.ops.kernels import stencil_gram
    from lanczos_tpu_torch.ops.kernels import stencil_kernel as sk

    left, right = sk.stencil_halos(op.spec_e, op.spec_h)
    zc, plane = op.spec.zc, op.spec.plane
    sms = build.sm_count(dev)
    picked_fn = stencil_gram.pair_gram_plan
    picked = picked_fn(op.spec_e, op.spec_h, P, 4, sms)

    def plan(**kw):
        return sk.gram_plan(zc, plane, left, right, P, 4, sms, **kw)

    others = [plan(zchunk=-(-zc // (picked.chunks + 1))),
              plan(columns=P // 2)]
    if picked.chunks > 1:
        others.append(plan(zchunk=-(-zc // (picked.chunks - 1))))

    def name(pl):
        occ = build.library().lt_stencil_blocks_per_sm(0, 2, 4, pl.smem_bytes)
        return (f"Z{pl.zchunk}xC{pl.columns} ({pl.strips}x{pl.chunks} blocks, "
                f"{pl.smem_bytes} B, {occ} a SM)")

    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((P,) + op.state_shape, generator=g, device=dev)
    dst, dst2 = torch.empty_like(q), torch.empty_like(q)

    def on(pl, d):
        stencil_gram.pair_gram_plan = lambda *args: pl
        try:
            return op.stencil_gram(q, d)[1]
        finally:
            stencil_gram.pair_gram_plan = picked_fn
    for other in others:
        _ab(f"K4 p={P}", lambda: on(picked, dst), lambda: on(other, dst2),
            names=(name(picked), name(other)))


def probe_gram_tiles(dev) -> None:
    from lanczos_tpu_torch.ops.kernels import block_dense

    S = 6 * 176 * 26624  # one column of the N=160 Maxwell state
    g = torch.Generator(device=dev).manual_seed(0)
    picked = block_dense.gram_tile
    for p in (1, P):
        q, v = torch.randn((2, p, S), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        v /= v.norm(dim=1, keepdim=True)
        calls = [("K3 (), v", block_dense.block_grams, ()),
                 ("K3 (q,), v", block_dense.block_grams, (q,))]
        if p == P:
            calls += [("K7 (), v", block_dense.block_grams_compensated, ()),
                      ("K7 (q,), v", block_dense.block_grams_compensated, (q,))]
        for label, fn, xs in calls:
            tile = picked(len(xs) * p + p, p)

            def on(t, fn=fn, xs=xs):
                block_dense.gram_tile = lambda K, p: t
                try:
                    return fn(xs, v, include_zz=True)
                finally:
                    block_dense.gram_tile = picked
            _ab(f"{label} include_zz p={p}", lambda: on(tile), lambda: on((12, 4)),
                names=(f"{tile[0]}x{tile[1]}", "12x4"))
        del q, v
    torch.cuda.empty_cache()


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
    a = synth_suitesparse_banded(ASSEMBLED_ROWS)
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


def dist_ell_rank(mesh):
    """One rank of --dist-ell: its shard of the assembled matrix, the two
    products timed, then the assembled slice's eigsh."""
    import numpy as np

    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh, ritz_residuals
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.parallel import gather_sharded_ell, halo_sharded_ell

    t0 = time.perf_counter()
    a = synth_suitesparse_banded(ASSEMBLED_ROWS)
    out = {"matrix_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    op = halo_sharded_ell(a, mesh)
    out["halo_build_s"] = time.perf_counter() - t0
    x = np.random.default_rng(0).standard_normal(
        (ASSEMBLED_P, a.shape[0])).astype(np.float32)
    b = op.pad_vector(torch.from_numpy(x))
    out.update(halo=op.halo, rows_loc=op.rows_loc,
               halo_ms=_mean_ms(lambda: op.mm(b)))
    gop = gather_sharded_ell(a, mesh)
    out["gather_ms"] = _mean_ms(lambda: gop.mm(b))
    del gop, a, x
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, vecs, _ = block_lanczos_eigsh(
        op, b, 12, 5, which="LA", reorth="full", normalize="qr",
        breakdown_eps=1e-4, replace_dead=True, eig_backend="newton",
        compute_vectors=True)
    torch.cuda.synchronize()
    out["eigsh_s"] = time.perf_counter() - t0
    out.update(vals=vals, resid=ritz_residuals(op, vals, vecs))
    return out


def _mean_ms(fn, iters=20, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dist_windowed_rank(mesh):
    """One rank of --dist-windowed: its windowed shard of the assembled
    matrix, its product timed whole and in parts, then the eigsh."""
    import numpy as np

    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh, ritz_residuals
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.parallel import halo_sharded_windowed

    t0 = time.perf_counter()
    a = synth_suitesparse_banded(ASSEMBLED_ROWS)
    out = {"matrix_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    op = halo_sharded_windowed(a, mesh)
    torch.cuda.synchronize()
    out["shard_s"] = time.perf_counter() - t0
    x = np.random.default_rng(0).standard_normal(
        (ASSEMBLED_P, a.shape[0])).astype(np.float32)
    b = op.pad_vector(torch.from_numpy(x))
    del a, x
    out.update(halo=op.halo, rows_loc=op.rows_loc, n128=op.n128, ppc=op.local.ppc,
               wsz=op.local.wsz, mm_ms=_mean_ms(lambda: op.mm(b)),
               k8_ms=_mean_ms(lambda: op.local.padded_mm(b)),
               copy_ms=_mean_ms(lambda: b.clone()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, vecs, _ = block_lanczos_eigsh(
        op, b, 12, 5, which="LA", reorth="full", normalize="qr",
        breakdown_eps=1e-4, replace_dead=True, eig_backend="newton",
        compute_vectors=True)
    torch.cuda.synchronize()
    out["eigsh_s"] = time.perf_counter() - t0
    out.update(vals=vals, resid=ritz_residuals(op, vals, vecs))
    return out


def _each_mesh_size(rank_fn):
    """(d, the ranks' results, wall seconds) for d = 1, 2, 4 ranks, one a
    card, skipping the sizes the machine has no cards for."""
    from lanczos_tpu_torch.parallel import launch

    cards = torch.cuda.device_count()
    for d in (1, 2, 4):
        if d > cards:
            print(f"skip d={d}: needs {d} cards, this machine has {cards}",
                  flush=True)
            continue
        t0 = time.perf_counter()
        ranks = launch.run(rank_fn, d, device="cuda", timeout=900)
        yield d, ranks, time.perf_counter() - t0


def probe_dist_ell() -> None:
    for d, ranks, wall in _each_mesh_size(dist_ell_rank):
        r0 = ranks[0]
        print(f"d={d}: halo {r0['halo']}, {r0['rows_loc']} rows a rank; "
              f"run {wall:.1f} s", flush=True)
        for rank, r in enumerate(ranks):
            print(f"  rank {rank}: halo-ELL SpMM p={ASSEMBLED_P} {r['halo_ms']:.4f} ms, "
                  f"all-gather ELL SpMM {r['gather_ms']:.4f} ms; matrix "
                  f"{r['matrix_s']:.2f} s, shard {r['halo_build_s']:.2f} s; "
                  f"eigsh {r['eigsh_s']:.3f} s", flush=True)
        print(f"  Ritz {r0['vals'].tolist()}; measured residuals "
              f"{r0['resid'].tolist()}", flush=True)


def probe_dist_windowed() -> None:
    for d, ranks, wall in _each_mesh_size(dist_windowed_rank):
        r0 = ranks[0]
        print(f"d={d}: halo {r0['halo']}, {r0['rows_loc']} rows a rank, strip "
              f"{r0['n128']}; run {wall:.1f} s", flush=True)
        for rank, r in enumerate(ranks):
            print(f"  rank {rank}: windowed SpMM p={ASSEMBLED_P} {r['mm_ms']:.4f} ms "
                  f"(K8 alone {r['k8_ms']:.4f} ms, state copy {r['copy_ms']:.4f} ms; "
                  f"ppc {r['ppc']}, wsz {r['wsz']}); matrix {r['matrix_s']:.2f} s, "
                  f"shard {r['shard_s']:.2f} s; eigsh {r['eigsh_s']:.3f} s", flush=True)
        print(f"  Ritz {r0['vals'].tolist()}; measured residuals "
              f"{r0['resid'].tolist()}", flush=True)


FDTD_CHUNKS = (32, 64, 128, 256, 512, 1024)


def probe_fdtd_graph(dev) -> None:
    from lanczos_tpu_torch.methods import fdtd

    cases = []
    o3 = PallasMaxwellOperator.create(3, 3, 3, dtype=torch.float64, device=dev)
    cases.append(("N=3 f64 p=1", o3, o3.pack(torch.from_numpy(
        gaussian_vector_b(3, o3.n)).to(dev)), 100_000, False))
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    cases.append((f"N={N} f32 p={P}", op, op.pack(torch.from_numpy(
        gaussian_matrix_B(N, op.n, P).astype("float32")).to(dev)), 2000, True))
    default = fdtd.GRAPH_CHUNK
    order = [None, *FDTD_CHUNKS, *reversed(FDTD_CHUNKS), None]
    try:
        for label, a, u0, steps, block in cases:
            dt = torch.tensor(1.0 / steps, dtype=u0.dtype, device=dev)
            secs, ref, worst = {}, None, 0.0
            for chunk in order:
                if chunk is not None:
                    fdtd.GRAPH_CHUNK = chunk
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                u = fdtd.euler_steps(a, u0, steps, dt, block=block,
                                     graph=chunk is not None)
                torch.cuda.synchronize(dev)
                secs.setdefault(chunk, []).append(time.perf_counter() - t0)
                if ref is None:
                    ref = u.clone()
                worst = max(worst, (u - ref).abs().max().item())
            for chunk in [None, *FDTD_CHUNKS]:
                t = secs[chunk]
                print(f"fdtd {label}, {steps} steps, "
                      f"{'eager' if chunk is None else f'graphs of {chunk}'}: "
                      f"{', '.join(f'{x:.3f}' for x in t)} s, "
                      f"{min(t) / steps * 1e6:.2f} us a step", flush=True)
            print(f"fdtd {label}: largest difference from the eager run {worst}",
                  flush=True)
    finally:
        fdtd.GRAPH_CHUNK = default


def library_tsqr(x: torch.Tensor, n_chunks: int = 8):
    """The TSQR T1 replaced, the yardstick of its tests and timings (the
    port never calls it): the block-major x (p, n) as a strided (n, p)
    view, padded into n_chunks chunks, one batched `torch.linalg.qr`, a QR
    of the stacked R factors, their product and a sign fix; q (p, n)
    block-major after a transpose copy, as block_lanczos made it."""
    import torch.nn.functional as F

    a = x.T
    n, p = a.shape
    c = max(1, min(n_chunks, n // max(p, 1)))
    rows = -(-n // c) * c
    blocks = F.pad(a, (0, 0, 0, rows - n)).reshape(c, rows // c, p)
    q1, r1 = torch.linalg.qr(blocks, mode="reduced")
    q2, r = torch.linalg.qr(r1.reshape(c * p, p), mode="reduced")
    q = torch.bmm(q1, q2.reshape(c, p, p)).reshape(rows, p)[:n]
    d = torch.sign(torch.diagonal(r))
    d = torch.where(d == 0, 1.0, d).to(r.dtype)
    return (q * d).T.contiguous(), r * d[:, None]


def qr_errors(x, q, r):
    """(||x^T - q^T r|| / ||x||, max |q q^T - I|), in float64."""
    x, q, r = x.double(), q.double(), r.double()
    eye = torch.eye(x.shape[0], dtype=torch.float64, device=x.device)
    return (float(torch.linalg.norm(x.T - q.T @ r) / torch.linalg.norm(x)),
            float((q @ q.T - eye).abs().max()))


TSQR_ROWS = 10_485_760
TSQR_CASES = ((8, torch.float32), (4, torch.float32), (16, torch.float32),
              (8, torch.float64))
COPY_GBS = 2987.6  # PERF.md: the measured device copy rate


def _launch_ms(fn, kernel: str = "tsqr") -> list:
    """Device ms of each `kernel` launch one call of fn makes, in order."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [round(e.time_range.elapsed_us() / 1e3, 4) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]


def probe_tsqr(dev) -> None:
    from lanczos_tpu_torch.ops.kernels.tsqr import (householder_tsqr,
                                                   tile_tree_plain, tsqr_plan)

    g = torch.Generator(device=dev).manual_seed(19)
    for p, dtype in TSQR_CASES:
        x = torch.randn((p, TSQR_ROWS), generator=g, device=dev, dtype=dtype)
        plan = tsqr_plan(TSQR_ROWS, p, x.element_size())
        mb = p * TSQR_ROWS * x.element_size() / 1e6
        full = _ms(lambda: householder_tsqr(x))
        r_only = _ms(lambda: householder_tsqr(x, want_q=False))
        plain = _ms(lambda: tile_tree_plain(x, plan), iters=3, warmup=1)
        library = _ms(lambda: library_tsqr(x), iters=3, warmup=1)
        q, r = householder_tsqr(x)
        ql, rl = library_tsqr(x)
        label = f"T1 p={p} {str(dtype)[6:]} n={TSQR_ROWS} (tile {plan.tile}, levels {plan.levels})"
        print(f"{label}: {full:.4f} ms a call ({3 * mb:.1f} MB: bound "
              f"{3 * mb / 3.35e6 * 1e3:.4f}, at copy {3 * mb / COPY_GBS:.4f} ms), "
              f"R alone {r_only:.4f} ms ({mb:.1f} MB: bound {mb / 3.35e6 * 1e3:.4f}); "
              f"plain {plain:.4f} ms, library {library:.4f} ms; "
              f"launches {plan.launches()} ({_launch_ms(lambda: householder_tsqr(x))} ms), "
              f"R alone {plan.launches(False)}", flush=True)
        print(f"{label}: errors (recon, orth) T1 {qr_errors(x, q, r)}, library "
              f"{qr_errors(x, ql, rl)}; |r - r_library| {float((r - rl).abs().max()):.3e}",
              flush=True)
        del q, r, ql, rl
        if (p, dtype) == TSQR_CASES[0]:
            plans = {tile: tsqr_plan(TSQR_ROWS, p, 4, TSQR_ROWS // tile) for tile in (512, 256)}
            times = {plan.tile: [], **{tile: [] for tile in plans}}
            for tile in [plan.tile, *plans, *reversed(plans), plan.tile]:
                times[tile].append(_ms(lambda: householder_tsqr(x, plan=plans.get(tile))))
            for tile, t in times.items():
                print(f"T1 p={p} f32 tile {tile}: {', '.join(f'{v:.4f}' for v in t)} ms",
                      flush=True)
        del x
        torch.cuda.empty_cache()


CGS2_ROWS = 10_485_760
CGS2_CASES = ((8, torch.float32, tuple(range(1, 13))), (4, torch.float32, (12,)),
              (16, torch.float32, (12,)), (8, torch.float64, (12,)))


def probe_cgs2(dev) -> None:
    from lanczos_tpu_torch.ops.kernels.cgs2 import cgs2, cgs2_plain, cgs2_plan

    g = torch.Generator(device=dev).manual_seed(23)
    for p, dtype, bs in CGS2_CASES:
        w = torch.randn((p, CGS2_ROWS), generator=g, device=dev, dtype=dtype)
        basis = torch.randn((max(bs), p, CGS2_ROWS), generator=g, device=dev,
                            dtype=dtype) / CGS2_ROWS ** 0.5
        block_mb = p * CGS2_ROWS * w.element_size() / 1e6
        ms, lib_ms = {}, {}
        for b in bs:
            q = basis[:b]
            t = {"kernel": [], "plain": []}
            for name in ("kernel", "plain", "plain", "kernel"):
                fn = (lambda: cgs2(w, q)) if name == "kernel" else (lambda: cgs2_plain(w, q))
                t[name].append(_ms(fn, iters=10))
            ms[b], lib_ms[b] = min(t["kernel"]), min(t["plain"])
            mb = (3 * b + 4) * block_mb
            got, want = cgs2(w, q), cgs2_plain(w, q)
            err = float((got - want).abs().max()) / float(w.abs().max())
            plan = cgs2_plan(b, p, w.element_size())
            moved = (3 * b + 5 if plan.chunks == 1 else 4 * b + 6 * plan.chunks) * block_mb
            print(f"C1 p={p} {str(dtype)[6:]} b={b} n={CGS2_ROWS} (stages {plan.stages}, "
                  f"chunks {plan.chunks}): kernel {', '.join(f'{v:.4f}' for v in t['kernel'])} ms, "
                  f"plain {', '.join(f'{v:.4f}' for v in t['plain'])} ms; "
                  f"{mb:.1f} MB: bound {mb / 3.35e6 * 1e3:.4f}, at copy "
                  f"{mb / COPY_GBS:.4f} ms, kernel at {mb / 3.35e6 * 1e3 / ms[b]:.1%} of the "
                  f"bound; C1 moves {moved:.1f} MB, the plain version "
                  f"{(4 * b + 10) * block_mb:.1f}; launches {plan.launches()} "
                  f"({_launch_ms(lambda: cgs2(w, q), 'cgs2')} ms); vs plain {err:.2e} of scale",
                  flush=True)
        if len(bs) > 1:
            calls = list(range(1, 12)) + list(range(2, 13))
            print(f"C1 p={p} eigsh request (22 calls, b = 1..11 and 2..12): kernel "
                  f"{sum(ms[b] for b in calls):.2f} ms, plain "
                  f"{sum(lib_ms[b] for b in calls):.2f} ms, bound "
                  f"{sum(3 * b + 4 for b in calls) * block_mb / 3.35e6 * 1e3:.2f} ms",
                  flush=True)
        del w, basis
        torch.cuda.empty_cache()


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
    if "--stencil-parts" in sys.argv[1:]:
        source = (sys.argv[sys.argv.index("--source") + 1]
                  if "--source" in sys.argv[1:] else None)
        probe_stencil_parts(dev, source)
        return
    if "--stencil-tiles" in sys.argv[1:]:
        probe_stencil_tiles(dev)
        return
    if "--assembled" in sys.argv[1:]:
        probe_assembled(dev)
        return
    if "--ab" in sys.argv[1:]:
        probe_ab(dev, sys.argv[sys.argv.index("--ab") + 1])
        return
    if "--gram-tiles" in sys.argv[1:]:
        probe_gram_tiles(dev)
        return
    if "--dist-ell" in sys.argv[1:]:
        probe_dist_ell()
        return
    if "--dist-windowed" in sys.argv[1:]:
        probe_dist_windowed()
        return
    if "--fdtd-graph" in sys.argv[1:]:
        probe_fdtd_graph(dev)
        return
    if "--tsqr" in sys.argv[1:]:
        probe_tsqr(dev)
        return
    if "--cgs2" in sys.argv[1:]:
        probe_cgs2(dev)
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
