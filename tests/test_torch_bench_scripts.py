"""The port's measurement entry points on the CPU at tiny sizes
(tests/test_bench_scripts.py for the port): the headline bench prints its
one JSON line, every driver and example runs with --device cpu, and each
raises without a card unless given --device cpu.

The convergence driver is held to the JAX package's
`benchmarks/convergence.py`, run in-process at the same settings (n=252,
f64, lc=30, 3000 FDTD steps): the two compute the same f64 receiver values
to ~1e-13 (the port through the folded-plane operator, JAX through the
flat one), so each m's relative error, a difference of two such values
near 1e-6, agrees to 1e-6 of itself.

The kernel_bench campaigns run with a short slope protocol (1 trial, a
0.1 ms resolution floor): the test checks the campaigns' rows and widths,
not the host's timing.
"""

import functools
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVERGENCE_RTOL = 1e-6


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_benchmarks_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_prints_one_json_line():
    r = subprocess.run([sys.executable, "-m", "lanczos_tpu_torch.bench", "--device",
                        "cpu", "--n-grid", "6"], cwd=REPO, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert set(d) == {"metric", "value", "unit", "vs_baseline"}
    assert d["metric"] == "maxwell_spmm_nnz_per_s"
    assert d["value"] > 0 and d["vs_baseline"] > 0


def test_bench_model_and_baseline_are_the_reference_scripts():
    from lanczos_tpu_torch import bench
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator

    assert bench.REF_NNZ_PER_S == 4 * 24.6e6 * 4 / 6.17e-3  # bench.py:66-69
    out = bench.measure(n_grid=4, p=2, device="cpu")
    n = PallasMaxwellOperator.create(4, 4, 4, device="cpu").n
    assert math.isclose(out["value"], 4 * n * 2 / out["seconds"], rel_tol=1e-12)
    assert math.isclose(out["vs_baseline"], out["value"] / bench.REF_NNZ_PER_S,
                        rel_tol=1e-12)


KB_SIZES = ["--device", "cpu", "--rows", "2000", "--rows-ts", "2000", "--grid", "3",
            "--grid-ell", "3", "--grid-dia", "12", "--grid-windowed", "3",
            "--rows-copy", "2000"]
KB_GROUPS = ["mm_tt,mm_tt2,mm_ts", "sqrtm", "spmm_ell,spmm_dia,spmm_stencil",
             "spmm_windowed,spmm_bsr", "copy_bw,block_mix,block_grams,"
             "block_grams_compensated", "fused_iter,dtype_f64"]


@pytest.fixture
def quick_slopes(monkeypatch):
    from lanczos_tpu_torch.benchmarks import kernel_bench
    from lanczos_tpu_torch.utils import bench_loop

    quick = dict(trials=1, min_delta_s=1e-4, k2_max=96)
    for name in ("slope_time", "slope_time_chain"):
        monkeypatch.setattr(kernel_bench, name,
                            functools.partial(getattr(bench_loop, name), **quick))
    return kernel_bench


@pytest.mark.parametrize("campaigns", KB_GROUPS)
def test_kernel_bench_campaigns(campaigns, quick_slopes, tmp_path):
    path = str(tmp_path / "k.json")
    quick_slopes.main(KB_SIZES + ["--only", campaigns, "--json", path])
    with open(path) as f:
        d = json.load(f)
    assert list(d) == campaigns.split(",")
    for name, rows in d.items():
        assert rows, name
        for r in rows:
            secs = [v for k, v in r.items() if k.startswith("seconds")]
            if "refused" in r:  # the windowed BSR engine above its plane cap
                assert name == "spmm_bsr" and r["block_size"] == 32
                continue
            assert secs and all(s > 0 or math.isnan(s) for s in secs), (name, r)
    ncols = quick_slopes.NCOLS
    if "sqrtm" in d:
        assert len(d["sqrtm"]) == 3 * len(ncols)
    if "block_mix" in d:
        assert [r["n_col"] for r in d["block_mix"]] == ncols
        assert [r["n_col"] for r in d["block_grams_compensated"]] == [2, 4, 6, 8]
    if "fused_iter" in d:
        mono = {r["n_col"]: r["seconds_mono"] for r in d["fused_iter"]}
        assert math.isnan(mono[1]) and math.isnan(mono[16])
        assert all(mono[p] > 0 for p in (2, 4, 8))


def test_kernel_bench_roofline_guard():
    from lanczos_tpu_torch.benchmarks import kernel_bench

    rows = [{"n_col": 2, "gbps": 100.0, "gbps_inplace": 150.0},
            {"n_col": 4, "gbps": 100.0, "gbps_inplace": 120.0}]
    assert kernel_bench.roofline_violations("block_mix", rows, 120.0) == [rows[0]]
    assert kernel_bench.roofline_violations("block_mix", rows, 140.0) == []
    # mm_tt's GB/s reproduce the reference's double-counting model: unguarded
    assert kernel_bench.roofline_violations("mm_tt", rows, 1.0) == []


def test_sweep_lanczos_block_and_vector(tmp_path):
    from lanczos_tpu_torch.benchmarks import sweep_lanczos

    path = str(tmp_path / "bl.csv")
    rows = sweep_lanczos.main(["--device", "cpu", "--n-col", "2", "--n-min", "3",
                               "--n-max", "4", "--m1", "2", "--m2", "4", "--csv", path])
    assert [r["n_grid"] for r in rows] == [3, 4]
    assert all(r["seconds_per_iter"] > 0 and r["p"] == 2 for r in rows)
    assert len(open(path).read().splitlines()) == 3
    rows = sweep_lanczos.main(["--device", "cpu", "--vector", "--n-min", "3",
                               "--n-max", "3", "--m1", "2", "--m2", "4"])
    assert rows[0]["p"] == 1 and rows[0]["route"] == "materialized"


def test_sweep_lanczos_ncol_windowed():
    from lanczos_tpu_torch.benchmarks import sweep_lanczos

    rows = sweep_lanczos.main(["--device", "cpu", "--sweep-ncol", "--operator",
                               "windowed", "--n-max", "8", "--m1", "2", "--m2", "4",
                               "--reorth", "full"])
    assert [r["p"] for r in rows] == [1, 8, 16]
    assert all(math.isfinite(r["per_vector_speedup_pct"]) for r in rows)


def test_sweep_lanczos_routes():
    from lanczos_tpu_torch.benchmarks.sweep_lanczos import iteration_model, route
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator

    op = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    assert [route(op, p, True) for p in (1, 2, 8, 9, 18)] == [
        "3-call", "mono", "mono", "3-call", "3-call"]
    assert route(op, 4, False) == "materialized"
    # the JAX script's model, copied
    jax_sweep = _jax_script("sweep_lanczos")
    for n, p in ((1000, 1), (24_600_000, 4), (12345, 18)):
        assert iteration_model(n, p) == jax_sweep.iteration_model(n, p)


def test_convergence_matches_the_jax_script(tmp_path, monkeypatch):
    from lanczos_tpu_torch.benchmarks import convergence

    settings = ["--fdtd-steps", "3000", "--m-max", "8"]
    path = str(tmp_path / "jax.csv")
    monkeypatch.setattr(sys, "argv", ["convergence.py", *settings, "--csv", path])
    _jax_script("convergence").main()
    want = np.loadtxt(path, delimiter=",", skiprows=1)
    rows = convergence.main(["--device", "cpu", *settings])
    got = np.array([[r["m"], r["rel_error"]] for r in rows])
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=CONVERGENCE_RTOL)


def test_convergence_block_runs():
    from lanczos_tpu_torch.benchmarks import convergence

    rows, fdtd_s, lanczos_s = convergence.curve(m_max=4, fdtd_steps=500, block=True,
                                                device="cpu")
    assert [r["m"] for r in rows] == [1, 2, 3, 4] and fdtd_s > 0 and lanczos_s > 0
    assert rows[-1]["rel_error"] < 1e-3


def test_suitesparse_scale_small(tmp_path):
    from lanczos_tpu_torch.benchmarks import suitesparse_scale

    path = str(tmp_path / "s.json")
    out = suitesparse_scale.main(["--device", "cpu", "--rows", "20000", "--m", "6",
                                  "--dist", "--json", path])
    assert json.load(open(path))["rows"] == 20000
    assert out["mtx_roundtrip"] and out["ppc"] == 15
    assert all(len(c["resid_measured"]) == len(c["ritz"]) for c in out["convergence"])
    assert max(out["measured_resid"]) < 1e-3 and len(out["top_ritz"]) == 5
    # --dist: the row-sharded windowed operator on 2 gloo ranks (JAX's keys)
    assert out["dist_devices"] == 2 and len(out["dist_spmm_seconds"]) == 2
    assert (out["dist_halo"], out["dist_rows_loc"]) == (4999, 10112)
    assert out["dist_spmm_nnz_per_s"] == pytest.approx(
        out["nnz"] * 8 / max(out["dist_spmm_seconds"]), rel=1e-12)


def test_tune_windowed_sweeps_the_plan_geometry(tmp_path):
    """Every (cpb, spg) of JAX's sweep is planned and timed, or marked
    refused; the rows' bytes are the port's K8 model (uint8 indices)."""
    from lanczos_tpu_torch.benchmarks import tune_windowed
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    path = str(tmp_path / "t.json")
    rows = tune_windowed.main(["--device", "cpu", "--rows", "6000", "--p", "2",
                               "--json", path])
    assert json.load(open(path)) == rows
    assert [(r["cpb"], r["spg"]) for r in rows] == [
        (c, g) for c in tune_windowed.CPBS for g in tune_windowed.SPGS]
    a = synth_suitesparse_banded(6000)
    for r in rows:
        assert r["seconds"] > 0 and "pct_of_copy_bw" not in r
        A = windowed_from_scipy(a, cpb=r["cpb"], spg=r["spg"], reorder="none",
                                device="cpu")
        nbytes = (A.planes_data.numel() * 4 + A.planes_lidx.numel()
                  + 4 * (A.planes_off.numel() + A.wb.numel()) + 2 * 2 * A.n128 * 4)
        assert (r["ppc"], r["wsz"]) == (A.ppc, A.wsz)
        assert r["gbps"] == pytest.approx(nbytes / r["seconds"] / 1e9, rel=1e-12)


def test_plots_draw_the_drivers_outputs(quick_slopes, tmp_path):
    """plots.py on the tiny drivers' outputs: every panel with data is
    written into --out, and only there."""
    pytest.importorskip("matplotlib")
    from lanczos_tpu_torch.benchmarks import convergence, plots, sweep_lanczos

    kj, bl, cv = (str(tmp_path / f) for f in ("k.json", "bl.csv", "c.csv"))
    quick_slopes.main(KB_SIZES + ["--only", "mm_ts,mm_tt,sqrtm,spmm_stencil,copy_bw,"
                                  "spmm_windowed", "--json", kj])
    sweep_lanczos.main(["--device", "cpu", "--n-col", "2", "--n-min", "3", "--n-max",
                        "4", "--m1", "2", "--m2", "4", "--csv", bl])
    convergence.main(["--device", "cpu", "--fdtd-steps", "500", "--m-max", "4",
                      "--csv", cv])
    out = tmp_path / "figures"
    written = plots.main(["--out", str(out), "--kernel-json", kj, "--block-csv", bl,
                          "--conv-csv", cv])
    assert sorted(os.path.basename(p) for p in written) == sorted(
        ["mm_ts.png", "mm_tt.png", "mm_tt2.png", "spmm_ell.png", "sqrtm.png",
         "spmm_stencil.png", "block_iteration.png", "spmm_windowed.png",
         "convergence.png"])
    assert sorted(os.listdir(out)) == sorted(os.path.basename(p) for p in written)
    assert all(os.path.getsize(p) > 1000 for p in written)


def test_suitesparse_convergence_curve_matches_jax():
    from lanczos_tpu_torch.benchmarks.suitesparse_scale import convergence_curve

    rng = np.random.default_rng(0)
    m, p = 5, 3
    alphas = rng.standard_normal((m, p, p)).astype(np.float32)
    alphas = alphas + alphas.transpose(0, 2, 1)
    betas = rng.standard_normal((m, p, p)).astype(np.float32)
    beta_final = rng.standard_normal((p, p)).astype(np.float32)
    got = convergence_curve(alphas, betas, beta_final, 4)
    want = _jax_script("suitesparse_scale").convergence_curve(alphas, betas,
                                                              beta_final, 4)
    assert [r["m"] for r in got] == [r["m"] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["ritz"], w["ritz"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g["resid"], w["resid"], rtol=1e-4, atol=1e-5)


EXAMPLES = {
    "eigsh_laplacian": (["--grid", "20", "--m", "40"], 1e-8),
    "expm_maxwell": (["--n-grid", "4", "--fdtd-steps", "2000"], 1e-3),
    "fused_and_compensated": (["--n", "256"], 1e-4),
    "windowed_general_matrix": (["--rows", "3000"], 1e-6),
    "inplace_fast_paths": (["--n-grid", "6", "--fdtd-steps", "3000"], 1e-3),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    argv, bound = EXAMPLES[name]
    mod = importlib.import_module(f"lanczos_tpu_torch.examples.{name}")
    err = mod.main(["--device", "cpu", *argv])
    assert math.isfinite(err) and err < bound


ENTRY_POINTS = ["lanczos_tpu_torch.bench"] + [
    f"lanczos_tpu_torch.benchmarks.{n}" for n in
    ("kernel_bench", "sweep_lanczos", "convergence", "suitesparse_scale",
     "tune_windowed")] + ["lanczos_tpu_torch.parallel.dryrun"] + [
    f"lanczos_tpu_torch.examples.{n}" for n in EXAMPLES]


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_without_a_card_is_an_error(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(module).main([])
