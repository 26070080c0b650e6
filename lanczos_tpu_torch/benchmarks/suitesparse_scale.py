"""An assembled >= 10M-row, >= 100M-nnz SuiteSparse-style banded SPD
matrix through the windowed-ELL kernel (K8) and block-Lanczos eigsh, end
to end on one card (port of `benchmarks/suitesparse_scale.py`, the JAX
package's north-star configs 4-5).

    python -m lanczos_tpu_torch.benchmarks.suitesparse_scale [--rows 10485760] [--dist] [--json PATH]

Records:
  * the host seconds to build the matrix and to plan it (the C++ planner,
    `lanczos_tpu_torch.native`);
  * SpMM nnz/s of K8 on the padded chained path (p block columns), beside
    the copy rate of the same state in the same window (the denominator:
    `spmm_pct_of_copy_bw` of the kernel's bytes);
  * m-step block Lanczos (p=8, m=12, reorth full, TSQR, replace_dead) and
    the iterations-to-converge curve: for every truncation m' <= m the
    top-k distinct Ritz values, the |beta_m' S| bound AND the measured
    relative residual ||A y - theta y|| / |theta| of each (one product of
    the k Ritz vectors a row, from the stored basis);
  * a .mtx round trip of a small slab through `io.load_sparse`, in a
    temporary directory.

The anti-overflow scale of the chained SpMM is folded into a second plan
of A / 1024 (a power of two: the same planes, exactly scaled), so no
extra pass over the state is timed.

--dist then times the row-sharded windowed operator (`parallel/
dist_windowed.py`, K8 on every rank's shard after the halo exchange) on
min(cards, 8) ranks, one a card (2 gloo ranks with --device cpu), as the
JAX script does (`benchmarks/suitesparse_scale.py:283-294`: no
reordering, the chain damped by 1e-2 a step): `dist_devices`, each
rank's seconds a product, and `dist_spmm_nnz_per_s` (nnz p over the
slowest rank's seconds).  Every rank builds the matrix from its seed and
plans only its shard.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from lanczos_tpu_torch.benchmarks import (
    add_device_argument,
    copy_rate,
    resolve_device,
    write_json,
)


def convergence_curve(alphas, betas, beta_final, k, cluster_rtol=1e-4,
                      measure=None):
    """Top-k DISTINCT Ritz values and their |beta S| residual bounds for
    every truncation m' <= m of the block-tridiagonal coefficients (NumPy
    arrays (m, p, p)); the port's copy of the JAX script's function.

    Values within `cluster_rtol` of a kept one (the ghost duplicates of a
    run without full reorthogonalization) join its cluster, which keeps
    the better bound.  measure(m', vals, S) -> measured relative residuals
    of the kept pairs, if given, adds "resid_measured" to every row."""
    m, p, _ = np.asarray(alphas).shape
    curve = []
    for mp in range(1, m + 1):
        t = np.zeros((mp * p, mp * p), np.asarray(alphas).dtype)
        for j in range(mp):
            t[j * p:(j + 1) * p, j * p:(j + 1) * p] = alphas[j]
        for j in range(mp - 1):
            t[(j + 1) * p:(j + 2) * p, j * p:(j + 1) * p] = betas[j + 1]
            t[j * p:(j + 1) * p, (j + 1) * p:(j + 2) * p] = betas[j + 1].T
        w, s = np.linalg.eigh(t)
        bf = np.asarray(betas[mp]) if mp < m else np.asarray(beta_final)
        resid_all = np.linalg.norm(bf @ s[-p:, :], axis=0)
        order = np.argsort(w)[::-1]
        scale = abs(w[order[0]]) if len(order) else 1.0
        ritz, resid, kept = [], [], []
        for i in order:
            if any(abs(w[i] - r) <= cluster_rtol * max(scale, 1.0) for r in ritz):
                j = int(np.argmin([abs(w[i] - r) for r in ritz]))
                resid[j] = min(resid[j], float(resid_all[i]))
                continue
            ritz.append(float(w[i]))
            resid.append(float(resid_all[i]))
            kept.append(i)
            if len(ritz) == k:
                break
        row = {"m": mp, "ritz": ritz, "resid": resid}
        if measure is not None:
            row["resid_measured"] = [float(x) for x in
                                     measure(mp, w[kept], s[:, kept])]
        curve.append(row)
    return curve


# the --dist chain lengths: fixed, so that every rank runs as many products
# (a slope escalated on one rank's clock could leave another waiting in an
# exchange)
DIST_K1, DIST_K2 = 2, 50


def dist_spmm_seconds(mesh, rows: int, p: int):
    """One rank of --dist: (seconds of one damped product on its shard,
    halo, rows a rank)."""
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.parallel import halo_sharded_windowed
    from lanczos_tpu_torch.utils.bench_loop import slope_time_chain

    a = synth_suitesparse_banded(rows)
    op = halo_sharded_windowed(a, mesh, reorder="none")
    x = np.random.default_rng(0).standard_normal((p, rows)).astype(np.float32)
    X = op.pad_vector(torch.from_numpy(x))
    del a, x
    sec = slope_time_chain(lambda y, A_: A_.mm(y), X, op, damp=1e-2, k1=DIST_K1,
                           k2=DIST_K2, k2_max=DIST_K2)
    return sec, op.halo, op.rows_loc


def run_dist(rows: int, p: int, nnz: int, device) -> dict:
    """--dist: the windowed operator on min(cards, 8) ranks (2 on the CPU)."""
    from lanczos_tpu_torch.parallel import launch

    n = min(torch.cuda.device_count(), 8) if device.type == "cuda" else 2
    ranks = launch.run(dist_spmm_seconds, n, rows, p, device=device.type,
                       timeout=1800)
    secs = [r[0] for r in ranks]
    out = {"dist_devices": n, "dist_halo": ranks[0][1], "dist_rows_loc": ranks[0][2],
           "dist_spmm_seconds": secs, "dist_spmm_nnz_per_s": nnz * p / max(secs)}
    print(f"dist({n} {device.type} ranks, halo {ranks[0][1]}, {ranks[0][2]} rows a "
        f"rank) spmm p={p}: {[f'{s * 1e3:.4f}' for s in secs]} ms a rank, "
        f"{out['dist_spmm_nnz_per_s']:.4e} nnz*col/s", flush=True)
    return out


def run(rows: int = 10_485_760, p: int = 8, m: int = 12, k: int = 5,
        reorth: str = "full", tol: float = 1e-3, device="cuda", log=print):
    from scipy.io import mmwrite

    from lanczos_tpu_torch.io import load_sparse
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.methods.eigs import ritz_residuals
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.window_ell import (
        PaddedWindowedOperator,
        windowed_from_scipy,
    )
    from lanczos_tpu_torch.utils.bench_loop import slope_time_chain
    from lanczos_tpu_torch.utils.timing import sync

    device = resolve_device(device)
    out = {"rows": rows, "p": p, "m": m, "k": k, "device": str(device)}
    t0 = time.perf_counter()
    a = synth_suitesparse_banded(rows)
    out["nnz"] = int(a.nnz)
    out["build_seconds"] = time.perf_counter() - t0
    log(f"assembled {a.shape[0]} rows, {a.nnz} nnz ({out['build_seconds']:.2f} s)",
        flush=True)

    slab = a[:2000, :2000].tocoo()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slab.mtx")
        mmwrite(path, slab)
        # Matrix Market keeps about 8 significant digits of an f32 value
        err = abs(slab.tocsr() - load_sparse(path)).max()
        out["mtx_roundtrip"] = bool(err <= 1e-6 * abs(slab).max())
    if not out["mtx_roundtrip"]:
        raise RuntimeError("the .mtx round trip changed the slab")
    log("mtx round-trip ok", flush=True)

    t0 = time.perf_counter()
    A = windowed_from_scipy(a, reorder="none", device=device)
    sync(device)
    out["plan_seconds"] = time.perf_counter() - t0
    out["ppc"], out["wsz"] = A.ppc, A.wsz
    log(f"plan {out['plan_seconds']:.2f} s ppc={A.ppc} wsz={A.wsz} ng={A.ng}",
        flush=True)

    rng = np.random.default_rng(0)
    Xp = A.pack(torch.from_numpy(rng.standard_normal((p, rows)).astype(np.float32))
                .to(device))
    A_t = windowed_from_scipy(a * np.float32(1.0 / 1024.0), reorder="none",
                              device=device)
    sec = slope_time_chain(lambda y, A_: A_.padded_mm(y), Xp, A_t, damp=None)
    del A_t
    out["spmm_seconds"] = sec
    out["spmm_nnz_per_s"] = a.nnz * p / sec
    if device.type == "cuda":
        out["copy_gbps"] = copy_rate(Xp)
    plane_bytes = sum(t.numel() * t.element_size()
                      for t in (A.planes_data, A.planes_lidx, A.planes_off, A.wb))
    out["spmm_gbps"] = (plane_bytes + 2 * Xp.numel() * Xp.element_size()) / sec / 1e9
    if "copy_gbps" in out:
        out["spmm_pct_of_copy_bw"] = 100.0 * out["spmm_gbps"] / out["copy_gbps"]
    log(f"spmm p={p}: {sec * 1e3:.4f} ms  {out['spmm_nnz_per_s']:.4e} nnz*col/s  "
        f"{out['spmm_gbps']:.1f} GB/s"
        + (f" ({out['spmm_pct_of_copy_bw']:.1f}% of the same-window copy rate "
           f"{out['copy_gbps']:.1f} GB/s)" if "copy_gbps" in out else ""), flush=True)

    # reorth full stores the basis anyway (m p n 4 B: 4 GB at the default
    # size); keeping it gives every truncation's Ritz vectors
    op = PaddedWindowedOperator(A)
    sync(device)
    t0 = time.perf_counter()
    res = block_lanczos(op, Xp, m, reorth=reorth, eig_backend="newton",
                        normalize="qr", breakdown_eps=1e-4, replace_dead=True,
                        store_basis=True)
    sync(device)
    out["lanczos_seconds"] = time.perf_counter() - t0

    def measure(mp, vals, s):
        basis = res.basis[:mp].reshape(mp * p, -1)
        s_t = torch.from_numpy(np.ascontiguousarray(s)).to(device, basis.dtype)
        vecs = basis.T @ s_t
        vals_t = torch.from_numpy(np.ascontiguousarray(vals)).to(device, basis.dtype)
        return ritz_residuals(op, vals_t, vecs).cpu().numpy()

    host = [np.asarray(x.cpu()) for x in (res.alphas, res.betas, res.beta_final)]
    curve = convergence_curve(*host, k, measure=measure)
    out["convergence"] = curve
    scale = max(abs(v) for v in curve[-1]["ritz"])
    out["iters_to_converge"] = next(
        (c["m"] for c in curve if max(c["resid"]) < tol * scale), None)
    out["iters_to_converge_measured"] = next(
        (c["m"] for c in curve if max(c["resid_measured"]) < tol), None)
    out["top_ritz"] = curve[-1]["ritz"]
    out["final_resid_bound"] = curve[-1]["resid"]
    out["measured_resid"] = curve[-1]["resid_measured"]
    for c in curve:
        log(f"  m={c['m']:2d} ritz {np.round(c['ritz'], 4).tolist()} bound "
            f"{np.array(c['resid']).max():.3e} measured "
            f"{np.array(c['resid_measured']).max():.3e}", flush=True)
    log(f"lanczos m={m}: {out['lanczos_seconds']:.3f} s  top-{k} Ritz "
        f"{out['top_ritz']}  measured_resid {out['measured_resid']}  "
        f"iters to {tol:g}: bound {out['iters_to_converge']}, measured "
        f"{out['iters_to_converge_measured']}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lanczos_tpu_torch.benchmarks.suitesparse_scale")
    ap.add_argument("--rows", type=int, default=10_485_760)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--m", type=int, default=12)
    ap.add_argument("--reorth", default="full")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--dist", action="store_true",
                    help="also time the row-sharded windowed operator on "
                         "min(cards, 8) ranks")
    ap.add_argument("--json", default=None, help="also write the results here")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    out = run(args.rows, args.p, args.m, args.k, args.reorth, args.tol, args.device)
    if args.dist:
        out.update(run_dist(args.rows, args.p, out["nnz"], resolve_device(args.device)))
    write_json(args.json, out)
    return out


if __name__ == "__main__":
    main()
