"""Timing probes of the port on one CUDA card, beyond `chip_smoke.py`.

    python -m lanczos_tpu_torch.probes
    python -m lanczos_tpu_torch.probes --stencil-tiles
    python -m lanczos_tpu_torch.probes --stencil-parts
    python -m lanczos_tpu_torch.probes --assembled
    python -m lanczos_tpu_torch.probes --ab OLD.cu
    python -m lanczos_tpu_torch.probes --gram-tiles

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

With --stencil-parts it prints only this: K1 and K5 at p=1 and p=4 and
K4 at p=4 on N=160 (f32), built five ways from `csrc/lanczos_kernels.cu`:
as it stands; K1/K5 without their taps (each output is 0 for K1, u for
K5: staging, barriers and stores only) and without their staging copies
(the taps read whatever the ring holds); K4 without its Gram sums and
without its staging copies; each timed as above, to show which part sets
the time.

With --ab OLD.cu it prints only this, a same-call A/B of the stencil
kernels: OLD.cu is the `csrc/lanczos_kernels.cu` of commit 500f53f
(`git show 500f53f:lanczos_tpu_torch/csrc/lanczos_kernels.cu`), with
K1/K5's strip interface and K4's and K6's before their redesign (one
thread a position, a grid of at most 1024 blocks, K4's sums in a second
launch),
built and loaded beside the current library.  K1 and K5 at p=1 and p=4
(unchanged since: the spread of the A/B), K4 at p=4 and K6's E half-call
at p=4, on N=160 (f32), each timed old, new, new, old (CUDA events, 20
calls after 2 warm-up calls), with the largest difference between the
two results.

With --gram-tiles it prints only this: K3 at the fused recurrence's calls
(`(), b` and `(q,), v`, include_zz: K = p and 2p) at p=1 and p=4, and K7 at
p=4, on N=160 Maxwell-sized states (f32), each on the register tile
`block_dense.gram_tile` picks and on the 12 x 4 tile, timed in turns
(picked, 12 x 4, 12 x 4, picked).
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


# the C interface of the kernels of commit 500f53f (`git show
# 500f53f:lanczos_tpu_torch/csrc/lanczos_kernels.cu`): K1/K5 as now, K4
# and K6 before their redesign
_STRIP = ("I", "P", "P", "P", "P", "IP", "IP", "I", "I", "I", "I", "P")
_OLD_SIGNATURES = {
    "lt_stencil_pair": _STRIP,
    "lt_fdtd_step": _STRIP,
    "lt_stencil_pair_gram": ("I", "P", "P", "P", "P", "IP", "I", "I", "I", "I",
                             "P", "I", "P", "P"),
    "lt_apply_stencil": ("I", "P", "P", "P", "P", "IP", "I", "I", "I", "LL",
                         "LL", "LL", "LL", "I", "P"),
}


def _old_library(path: str):
    import ctypes
    from pathlib import Path

    types = {"I": ctypes.c_int, "P": ctypes.c_void_p, "LL": ctypes.c_longlong,
             "IP": ctypes.POINTER(ctypes.c_int)}
    source = build.SOURCE
    try:
        build.SOURCE = Path(path).resolve()
        lib = ctypes.CDLL(str(build.build()))
    finally:
        build.SOURCE = source
    for name, sig in _OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = [types[t] for t in sig]
        getattr(lib, name).restype = ctypes.c_int
    return lib


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
    import dataclasses

    from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
        generic_tap_table,
        pair_plan,
        stencil_into,
        tap_table,
    )

    old = _old_library(old_path)
    build.library()
    st = torch.cuda.current_stream(dev).cuda_stream
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    a_dt = op.scaled(1.0 / FDTD_STEPS)
    taps = tap_table(op.spec_e, op.spec_h)
    zc, plane, nt = op.spec.zc, op.spec.plane, op.wz_t.shape[-1]
    g = torch.Generator(device=dev).manual_seed(0)
    for p in (1, P):
        u = torch.randn((p,) + op.state_shape, generator=g, device=dev)
        outs = [torch.empty_like(u) for _ in range(3)]
        plan = pair_plan(op.spec_e, op.spec_h, p, 4, build.sm_count(dev))

        def old_call(entry, a, out):
            def run():
                build.check(getattr(old, entry)(
                    0, u.data_ptr(), out.data_ptr(), a.wz_t.data_ptr(),
                    a.wplane_s.data_ptr(), taps, plan.ints, p, zc, plane, nt,
                    st), entry)
                return out
            return run

        _ab(f"K1 apply_stencil_pair p={p}", old_call("lt_stencil_pair", op, outs[0]),
            lambda: op.mm(u))
        _ab(f"K5 fdtd_step p={p}", old_call("lt_fdtd_step", a_dt, outs[1]),
            lambda: a_dt.fdtd_step(u, outs[2]))
        del outs
    # K4 at the block slice's p: each side overwrites its own dst with v
    dst_old, dst_new = u.clone(), u.clone()
    q = torch.randn_like(u)
    nblocks = build.grid_blocks(6 * zc * plane)  # the old K4's grid
    partial = torch.empty((nblocks, 3 * P, P), device=dev)
    g3 = torch.empty((3 * P, P), device=dev)

    def old_k4():
        build.check(old.lt_stencil_pair_gram(
            0, q.data_ptr(), dst_old.data_ptr(), op.wz_t.data_ptr(),
            op.wplane_s.data_ptr(), taps, P, zc, plane, nt, partial.data_ptr(),
            nblocks, g3.data_ptr(), st), "lt_stencil_pair_gram")
        return g3

    _ab(f"K4 apply_stencil_pair_gram p={P} (g3)", old_k4,
        lambda: op.stencil_gram(q, dst_new)[1])
    # K6: the E half-call of an unpaired pair, as chip_smoke times it
    spec = dataclasses.replace(op.spec_e, paired=False)
    wz, wp = op.wz_t[0].T, op.wplane_s[0]
    out_old, out_new = torch.zeros_like(u), torch.zeros_like(u)

    def old_k6():
        src, dst = u[:, 3:6], out_old[:, 0:3]
        build.check(old.lt_apply_stencil(
            0, src.data_ptr(), dst.data_ptr(), wz.data_ptr(), wp.data_ptr(),
            generic_tap_table(spec), P, zc, plane, src.stride(0),
            dst.stride(0), wz.stride(0), wz.stride(1),
            build.grid_blocks(zc * plane), st), "lt_apply_stencil")
        return dst

    _ab(f"K6 apply_stencil E half p={P}", old_k6,
        lambda: stencil_into(u[:, 3:6], out_new[:, 0:3], wz, wp, spec))
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
# K1/K5 strip body's taps or staging copies, K4's Gram sums or staging
_STENCIL_PARTS = {
    "as built": (),
    "K1/K5 no taps": ((
        "        if (a.paired[h]) {\n#pragma unroll\n"
        "          for (int k = 0; k + 1 < kMaxTaps; k += 2) {\n"
        "            if (k + 1 >= a.n[c]) break;\n            // the pair's",
        "        if (true) {} else if (a.paired[h]) {\n#pragma unroll\n"
        "          for (int k = 0; k + 1 < kMaxTaps; k += 2) {\n"
        "            if (k + 1 >= a.n[c]) break;\n            // the pair's"),),
    "K1/K5 no staging": (("                cp_async16(slot",
                          "                if (false) cp_async16(slot"),),
    "K4 no Gram": (("            if (!TILED || in_tile(j)) {",
                    "            if (false) {"),
                   ("            if (!TILED || in_tile(k))\n",
                    "            if (false)\n")),
    "K4 no staging": (("          cp_async16(sb + (i + k * kThreads)",
                       "          if (false) cp_async16(sb + (i + k * kThreads)"),
                      ("          cp_async16(db + bb * dcol",
                       "          if (false) cp_async16(db + bb * dcol")),
}


def probe_stencil_parts(dev) -> None:
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    a_dt = op.scaled(1.0 / FDTD_STEPS)
    g = torch.Generator(device=dev).manual_seed(0)
    us = {p: torch.randn((p,) + op.state_shape, generator=g, device=dev)
          for p in (1, P)}
    outs = {p: torch.empty_like(u) for p, u in us.items()}
    q, dst = us[P], torch.empty_like(us[P])
    source = build.SOURCE
    text = source.read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        for name, edits in _STENCIL_PARTS.items():
            part = text
            for old, new in edits:
                if part.count(old) != 1:
                    raise RuntimeError(f"the kernel source no longer has {old!r}")
                part = part.replace(old, new)
            tag = name.replace(" ", "_").replace("/", "")
            path = build.BUILD_DIR / f"stencil_part_{tag}.cu"
            # a line of its own makes each part a build of its own
            path.write_text(f"// stencil part: {name}\n" + part)
            build.SOURCE, build._lib = path, None
            times = []
            for p in (1, P):
                u, out = us[p], outs[p]
                times.append(f"K1 p={p} {_ms(lambda: op.mm(u)):.4f} ms, K5 p={p} "
                             f"{_ms(lambda: a_dt.fdtd_step(u, out)):.4f} ms")
            times.append(f"K4 p={P} {_ms(lambda: op.stencil_gram(q, dst)):.4f} ms")
            print(f"stencil part {name}: " + ", ".join(times), flush=True)
    finally:
        build.SOURCE, build._lib = source, None


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
    if "--stencil-parts" in sys.argv[1:]:
        probe_stencil_parts(dev)
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
