"""The benchmark figures from the port's drivers (port of
`benchmarks/plots.py`, the counterpart of the reference's
`source/lanczos_plots.m`).

    python -m lanczos_tpu_torch.benchmarks.plots --out DIR \\
        [--kernel-json K.json] [--block-csv BL.csv] [--conv-csv C.csv] \\
        [--ncol-csv NCOL.csv] [--ncol-windowed-csv NCOLW.csv]

Inputs, each optional (a panel without its data is skipped, the
reference's curve drawn alone where it has one):
  * `kernel_bench --json`: mm_ts, mm_tt, mm_tt2 (GB/s by the reference's
    byte model) and spmm_ell (GFLOPS) against the reference's Tesla T4
    kernels and cuBLAS; sqrtm per eig backend against the T4 warp kernel
    and syevjBatched; spmm_stencil nnz*col/s against the T4 ell::SpMM at
    N_COL=4 and the copy_bw roofline; spmm_windowed against the T4's
    gathered ell::SpMM;
  * `sweep_lanczos --csv` (block): seconds an iteration against n;
  * `sweep_lanczos --sweep-ncol --csv` (stencil and `--operator windowed`):
    the per-vector speedup of block over single-vector Lanczos;
  * `convergence --csv`: the relative error against m, beside the
    reference's curve.

The reference's numbers are the JAX script's table (BASELINE.md's
transcription of `lanczos_plots.m`).  Host only: matplotlib is imported
in `main`, and the figures go to --out (PNG), never to
`benchmarks/results/`, which holds the JAX package's.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

# Okabe-Ito blue / vermillion (a colour-blind-safe pair): the port first,
# the reference second
C_OURS, C_REF, C_REF2 = "#0072B2", "#D55E00", "#555555"
OURS = "lanczos_tpu_torch"

NCOLS = [2, 4, 6, 8, 10, 12, 14, 16, 18]

# Tesla T4, lanczos_plots.m via BASELINE.md (the JAX script's table)
REF = {
    "mm_ts_gbps": [238.5, 235.5, 231.2, 229.6, 225.4, 229.5, 226.0, 225.7, 224.6],
    "mm_ts_cublas_gbps": [170.3, 175.9, 147.1, 165.0, 158.0, 185.8, 209.9, 240.6, 222.2],
    "mm_tt_gbps": [533.4, 538.5, 533.9, 530.2, 491.2, 490.5, 429.9, 369.0, 346.8],
    "mm_tt_cublas_gbps": [29.6, 57.1, 82.4, 105.8, 125.3, 145.4, 164.0, 182.3, 198.4],
    "mm_tt2_gbps": [542.8, 533.1, 520.5, 525.6, 512.7, 498.0, 420.1, 391.4, 354.4],
    "mm_tt2_cublas_gbps": [28.8, 54.2, 76.8, 96.8, 114.1, 114.0, 142.9, 153.5, 161.3],
    "spmm_gflops": [88.1, 128.6, 150.4, 163.8, 173.4, 180.5, 185.6, 190.0, 193.6],
    "sqrtm_s": [3.88e-6, 1.27e-5, 2.38e-5, 4.11e-5, 5.37e-5, 6.29e-5, 7.59e-5, 1.16e-4, 1.31e-4],
    "sqrtm_cusolver_s": [2.52e-5, 2.18e-5, 2.23e-5, 2.29e-5, 2.99e-5, 3.94e-5, 6.18e-5, 7.66e-5, 8.43e-5],
    "block_iter_s": [0.0286, 0.0525, 0.0800, 0.1094, 0.1221, 0.1421, 0.1658, 0.1980, 0.2547],
    # problem size 252, m = 1..12 (lanczos_plots.m:168)
    "conv_relerr": [5.53e-2, 7.69e-4, 1.53e-4, 6.65e-7, 3.88e-7, 1.05e-9,
                    2.86e-9, 1.84e-9, 1.83e-9, 1.83e-9, 1.83e-9, 1.83e-9],
    # the T4's gathered ell::SpMM at 24.6M rows, seconds per N_COL
    "ell_spmm_s": [4.51e-3, 6.17e-3, 7.92e-3, 9.70e-3, 1.14e-2, 1.32e-2,
                   1.50e-2, 1.67e-2, 1.85e-2],
}
T4_ROWS = 24.6e6


def _valid(r):
    # a slope the protocol could not resolve reads ~1e-12 s: not a rate
    return r.get("seconds", 1.0) > 2e-9


def _series(rows, key, where=None):
    rows = [r for r in rows if _valid(r) and r.get("n_col") in NCOLS
            and all(r.get(k) == v for k, v in (where or {}).items())]
    return [r["n_col"] for r in rows], [r[key] for r in rows]


def _read_csv(path):
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


class Figures:
    """Draws and saves one PNG a panel into `out`."""

    def __init__(self, plt, out):
        self.plt, self.out, self.written = plt, out, []

    def axes(self):
        return self.plt.subplots(figsize=(5.2, 3.4))

    def save(self, fig, ax, name, title, xlabel, ylabel):
        ax.set_title(title, fontsize=11)
        ax.set_xlabel(xlabel, fontsize=9)
        ax.set_ylabel(ylabel, fontsize=9)
        ax.grid(True, color="#e0e0e0", linewidth=0.6, zorder=0)
        ax.spines[["top", "right"]].set_visible(False)
        ax.tick_params(labelsize=8)
        ax.legend(fontsize=8, frameon=False)
        path = os.path.join(self.out, name)
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        self.plt.close(fig)
        self.written.append(path)
        print(f"wrote {path}", flush=True)


def kernel_panel(figs, rows, bench, key, refs, ylabel):
    fig, ax = figs.axes()
    xs, ys = _series(rows, key)
    if xs:
        ax.plot(xs, ys, color=C_OURS, lw=2, marker="o", ms=5, label=OURS, zorder=3)
    for ref_key, label, colour in refs:
        ax.plot(NCOLS, REF[ref_key], color=colour, lw=2, marker="s", ms=4,
                label=label, zorder=2)
    figs.save(fig, ax, f"{bench}.png", bench, "block width N_COL", ylabel)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.benchmarks.plots")
    ap.add_argument("--out", required=True, help="directory for the PNGs")
    ap.add_argument("--kernel-json", default=None, help="kernel_bench --json output")
    ap.add_argument("--block-csv", default=None, help="sweep_lanczos --csv output")
    ap.add_argument("--conv-csv", default=None, help="convergence --csv output")
    ap.add_argument("--ncol-csv", default=None,
                    help="sweep_lanczos --sweep-ncol --csv output")
    ap.add_argument("--ncol-windowed-csv", default=None,
                    help="the same with --operator windowed")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out, exist_ok=True)
    figs = Figures(plt, args.out)
    kern = {}
    if args.kernel_json and os.path.exists(args.kernel_json):
        with open(args.kernel_json) as f:
            kern = json.load(f)

    # 1-4: the dense kernels and the gathered ELL SpMM against the T4's
    byte_model = "effective GB/s (reference byte model)"
    for bench in ("mm_ts", "mm_tt", "mm_tt2"):
        kernel_panel(figs, kern.get(bench, []), bench, "gbps",
                     [(f"{bench}_gbps", "T4 custom kernel", C_REF),
                      (f"{bench}_cublas_gbps", "T4 cuBLAS", C_REF2)], byte_model)
    kernel_panel(figs, kern.get("spmm_ell", []), "spmm_ell", "gflops",
                 [("spmm_gflops", "T4 ell::SpMM", C_REF)], "GFLOPS")

    # 5: sqrtm + inverse sqrtm per eig backend against the reference's two
    fig, ax = figs.axes()
    for backend, colour, marker in (("jacobi", C_OURS, "o"), ("newton", "#009E73", "D"),
                                    ("lax", "#7a4bd6", "^")):
        xs, ys = _series(kern.get("sqrtm", []), "seconds", {"backend": backend})
        if xs:
            ax.plot(xs, ys, color=colour, lw=2, marker=marker, ms=5,
                    label=f"{backend} ({OURS})", zorder=3)
    ax.plot(NCOLS, REF["sqrtm_s"], color=C_REF, lw=2, marker="s", ms=4,
            label="T4 warp kernel", zorder=2)
    ax.plot(NCOLS, REF["sqrtm_cusolver_s"], color=C_REF2, lw=2, marker="s", ms=4,
            label="T4 syevjBatched", zorder=2)
    ax.set_yscale("log")
    figs.save(fig, ax, "sqrtm.png", "sqrtm", "block width N_COL",
              "seconds per sqrtm + inverse")

    # the stencil SpMM (K1) against the T4's ELL SpMM at N_COL=4 and the
    # copy roofline: a stencil product moves the state once each way
    stencil = [r for r in kern.get("spmm_stencil", []) if _valid(r)]
    if stencil:
        fig, ax = figs.axes()
        ax.plot([r["n_col"] for r in stencil], [r["nnz_per_s"] / 1e9 for r in stencil],
                color=C_OURS, lw=2, marker="o", ms=5, label=f"stencil K1 ({OURS})",
                zorder=3)
        ax.axhline(4 * T4_ROWS * 4 / REF["ell_spmm_s"][1] / 1e9, color=C_REF, lw=2,
                   ls="--", label="T4 ell::SpMM, N_COL=4", zorder=2)
        copy = [r for r in kern.get("copy_bw", []) if r.get("n_col") == 4]
        if copy:
            ax.axhline(copy[0]["copy_gbps"] / 2, color="#999999", lw=1.5, ls=":",
                       label="measured copy roofline", zorder=1)
        figs.save(fig, ax, "spmm_stencil.png", "spmm_stencil", "block columns p",
                  "Gnnz/s x block columns")

    # 6a: block Lanczos seconds an iteration against the problem size
    block = [r for r in _read_csv(args.block_csv) if float(r["seconds_per_iter"]) > 2e-9]
    if block:
        fig, ax = figs.axes()
        ax.plot([int(r["n"]) for r in block], [float(r["seconds_per_iter"]) for r in block],
                color=C_OURS, lw=2, marker="o", ms=5, label=f"{OURS}, p={block[0]['p']}",
                zorder=3)
        # the reference: an iteration pair at ~24.6M rows, N_COL=4
        ax.plot([T4_ROWS], [REF["block_iter_s"][1] / 2], color=C_REF, marker="s",
                ms=7, ls="none", label="T4, N_COL=4 (an iteration)", zorder=2)
        ax.set_xscale("log")
        ax.set_yscale("log")
        figs.save(fig, ax, "block_iteration.png", "block Lanczos time an iteration",
                  "problem size n", "seconds / iteration")

    # 5b: the windowed-ELL SpMM (K8) against the T4's gathered ell::SpMM
    windowed = kern.get("spmm_windowed", [])
    if windowed:
        fig, ax = figs.axes()
        for fixture, colour, marker in (("laplacian_2d", C_OURS, "o"),
                                        ("maxwell_w4", "#009E73", "D")):
            rows = [r for r in windowed if _valid(r) and r.get("fixture") == fixture]
            if rows:
                ax.plot([r["n_col"] for r in rows], [r["nnz_per_s"] / 1e9 for r in rows],
                        color=colour, lw=2, marker=marker, ms=5,
                        label=f"K8 {fixture} ({OURS})", zorder=3)
        ax.plot(NCOLS, [T4_ROWS * 4 * p / t / 1e9 for p, t in zip(NCOLS, REF["ell_spmm_s"])],
                color=C_REF, lw=2, marker="s", ms=4, label="T4 ell::SpMM (24.6M rows)",
                zorder=2)
        ax.set_yscale("log")
        figs.save(fig, ax, "spmm_windowed.png", "assembled-matrix SpMM",
                  "block columns p", "Gnnz/s x block columns")

    # 6c: the per-vector speedup of block over single-vector Lanczos
    # (lanczos_plots.m:150)
    ncol = [r for r in _read_csv(args.ncol_csv) if int(r["p"]) > 1]
    ncol_w = [r for r in _read_csv(args.ncol_windowed_csv) if int(r["p"]) > 1]
    if ncol or ncol_w:
        fig, ax = figs.axes()
        for rows, colour, marker, label in ((ncol, C_OURS, "o", "stencil"),
                                            (ncol_w, "#7a4bd6", "^", "windowed ELL")):
            if rows:
                ax.plot([int(r["p"]) for r in rows],
                        [float(r["per_vector_speedup_pct"]) for r in rows],
                        color=colour, lw=2, marker=marker, ms=5,
                        label=f"{label} ({OURS})", zorder=3)
        # the T4's single-vector iteration took 0.0166 s
        ax.plot(NCOLS, [(1.0 / ((t / 2 / p) / 0.0166) - 1.0) * 100.0
                        for p, t in zip(NCOLS, REF["block_iter_s"])],
                color=C_REF, lw=2, marker="s", ms=4, label="T4 (lanczos_plots.m:150)",
                zorder=2)
        ax.axhline(0, color="#999999", lw=1)
        figs.save(fig, ax, "block_speedup.png",
                  "per-vector speedup, block vs single Lanczos", "block width N_COL",
                  "speedup %")

    # 6b: convergence against the FDTD oracle, the reference's curve always
    fig, ax = figs.axes()
    ax.plot(range(1, 13), REF["conv_relerr"], color=C_REF, lw=2, marker="s", ms=4,
            label="reference (T4, n=252)", zorder=2)
    conv = _read_csv(args.conv_csv)
    if conv:
        ax.plot([int(r["m"]) for r in conv], [float(r["rel_error"]) for r in conv],
                color=C_OURS, lw=2, marker="o", ms=5, label=OURS, zorder=3)
    ax.set_yscale("log")
    figs.save(fig, ax, "convergence.png", "Lanczos expm vs FDTD convergence",
              "iterations m", "relative error")
    return figs.written


if __name__ == "__main__":
    main()
