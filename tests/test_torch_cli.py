"""The port's CLI (`python -m lanczos_tpu_torch`) against the JAX
package's `lanczos_tpu.cli.run`, on the CPU: the same config through both,
comparing `solution` and `relative_error`.  The block slice on the
folded-plane operator with the fused recurrence auto (materialized at this
size), forced (the mono step) and off (--no-fused); `--vector` on the
folded-plane and on the default flat-state operator (`--operator
stencil`); the stencil block driver; and `--compensated`.

Tolerances, relative to the solution's scale:
- f64, 1e-10: rounding in different operation orders.
- f32 with the fixture's start block, 5e-4: its four Gaussian start
  columns are nearly collinear, so B^T B has condition 7.5e7 at N=6
  (eigenvalues 6.7e-6 .. 5.0e2), beyond f32's 1/eps.  Its smallest
  eigen-direction is rounding noise in any f32 Gram (eps * ||B^T B|| =
  3e-5), and two correct f32 implementations then agree only to ~1e-4: the
  JAX package's own jacobi and lax eig backends differ by 8e-5 here, and
  both packages sit 1e-5 .. 1.6e-4 from the f64 answer
  (test_f32_noise_floor_of_the_fixture).
- f32 with the fixture's columns orthonormalized in f64 (the same span,
  condition 1), 1e-5: the whole slice, fixture to FDTD, at f32 precision
  (the two packages agree to 2.1e-6 there, and each to 1.2e-6 of f64).
- f32 `--vector`, 1e-5: a single Gaussian start vector has none of the
  block fixture's collinearity (measured: <= 4.3e-7 on a CPU).
- f32 `--compensated`, as the block slice: 5e-4 with the fixture's start
  block (both packages sit 4.7-4.9e-4 from f64 there, 3.7e-5 apart: a
  compensated Gram cannot restore the start block's lost direction) and
  1e-5 with it orthonormalized (2.1e-6 apart).
- f32 `--operator ell`, as the block slice (5e-4 with the fixture, 1e-5
  orthonormalized); in f64 it is held to the port's own `--operator
  stencil` to 1e-12 (the JAX package builds its ELL planes in f32 whatever
  --dtype says, so its f64 run is not an f64 oracle).
- f64 block `--reorth` / `--normalize qr`, 1e-12, as the other f64 runs.  The compensated runs use
  the flat-state operator, whose JAX K7 takes its exact f64 branch: JAX's
  interpret-mode K7 needs over a minute to trace on a folded-plane state.

The JAX runs are cached per process, and only the default run (fused=None,
jacobi, the fixture's start block) validates against FDTD on the JAX side:
the oracle does not depend on the recurrence (test_torch_lanczos_f64.py
holds fdtd_block to JAX), and Pallas in interpret mode makes it the
costliest part of a JAX run.  The port validates every run."""

import contextlib
import functools
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import lanczos_tpu.models.rhs
import lanczos_tpu_torch.models.rhs
from lanczos_tpu.cli import run as jax_run
from lanczos_tpu.config import LanczosConfig as JaxConfig
from lanczos_tpu_torch.cli import build_parser, config_from_args, run
from lanczos_tpu_torch.config import LanczosConfig

F32_SOLUTION_RTOL = 5e-4
F32_WELL_CONDITIONED_RTOL = 1e-5
F64_RTOL = 1e-12
SLICE = dict(n_grid=6, m=6, n_col=4, operator="pallas", lc=20, fdtd_steps=200)
VECTOR = dict(n_grid=6, m=8, block=False, operator="pallas", lc=20, fdtd_steps=200)
STENCIL_VECTOR = dict(n_grid=3, m=8, block=False, reorth="full", lc=20,
                      fdtd_steps=500)
STENCIL_BLOCK = dict(n_grid=3, m=6, n_col=4, lc=20, fdtd_steps=500,
                     eig_backend="lax")
COMPENSATED = dict(n_grid=3, m=6, n_col=4, lc=20, fdtd_steps=500,
                   compensated=True)
ELL = dict(n_grid=6, m=6, n_col=4, operator="ell", lc=20, fdtd_steps=200)


def _orthonormal_columns(n_grid, n_rows, n_col,
                         fixture=lanczos_tpu_torch.models.rhs.gaussian_matrix_B):
    """The fixture's start block with its columns orthonormalized in f64."""
    return np.linalg.qr(fixture(n_grid, n_rows, n_col).T)[0].T.copy()


@contextlib.contextmanager
def start_block(start):
    """Both CLIs build their start block from this one (block-major)."""
    with pytest.MonkeyPatch.context() as mp:
        if start == "orthonormal":
            for mod in (lanczos_tpu.models.rhs, lanczos_tpu_torch.models.rhs):
                mp.setattr(mod, "gaussian_matrix_B", _orthonormal_columns)
        yield


@functools.lru_cache(maxsize=None)
def jax_result(dtype, fused, eig_backend="jacobi", start="fixture"):
    """The JAX CLI's run of SLICE, once per worker process."""
    default = (fused, eig_backend, start) == (None, "jacobi", "fixture")
    with start_block(start):
        return jax_run(JaxConfig(**SLICE, dtype=dtype, fused=fused,
                                 eig_backend=eig_backend, validate=default))


def compare_with_jax(dtype, fused, rtol, start="fixture"):
    want = jax_result(dtype, fused, start=start)
    with start_block(start):
        got = run(LanczosConfig(**SLICE, dtype=dtype, fused=fused,
                                device="cpu"))
    sj, st = np.asarray(want["solution"]), np.asarray(got["solution"])
    assert st.shape == sj.shape == (4,)
    assert np.abs(st - sj).max() <= rtol * np.abs(sj).max()
    assert (got["n"], got["lc"]) == (want["n"], want["lc"])
    # the FDTD oracle agrees too: the relative errors are both small and
    # differ by no more than the solutions do
    assert got["relative_error"] < 1e-3
    if "relative_error" in want:
        assert abs(got["relative_error"] - want["relative_error"]) <= 2 * rtol


@functools.lru_cache(maxsize=None)
def jax_run_of(items, start="fixture"):
    """The JAX CLI's run of one config (a sorted item tuple), once per
    worker process."""
    with start_block(start):
        return jax_run(JaxConfig(**dict(items)))


def compare_config(cfg, rtol, start="fixture"):
    """The port against JAX on one config: solutions to rtol of their
    scale, the same n and lc, and relative errors under 1e-3 that differ
    by no more than twice rtol."""
    want = jax_run_of(tuple(sorted(cfg.items())), start)
    with start_block(start):
        got = run(LanczosConfig(**cfg, device="cpu"))
    sj = np.atleast_1d(np.asarray(want["solution"]))
    st = np.atleast_1d(np.asarray(got["solution"]))
    assert st.shape == sj.shape
    assert np.abs(st - sj).max() <= rtol * np.abs(sj).max()
    assert (got["n"], got["lc"], got["block"]) == (want["n"], want["lc"],
                                                    want["block"])
    assert got["relative_error"] < 1e-3
    assert abs(got["relative_error"] - want["relative_error"]) <= 2 * rtol * (
        1 + want["relative_error"])


@pytest.mark.parametrize("dtype,fused", [
    ("float32", None), ("float32", True), ("float64", None),
])
def test_cli_vector_matches_jax(dtype, fused):
    """--vector on the folded-plane operator: the classic recurrence at
    this size, or the fused route at block width 1 when forced."""
    compare_config(VECTOR | dict(dtype=dtype, fused=fused),
                   F64_RTOL if dtype == "float64" else F32_WELL_CONDITIONED_RTOL)


@pytest.mark.parametrize("dtype,reorth", [
    ("float64", "full"), ("float32", "full"), ("float64", "selective"),
    ("float64", "periodic"),
])
def test_cli_vector_on_the_default_operator_matches_jax(dtype, reorth):
    """--vector with no --operator (the flat-state MaxwellOperator), as
    tests/test_cli.py:23-28 drives the JAX CLI; periodic is none there."""
    compare_config(STENCIL_VECTOR | dict(dtype=dtype, reorth=reorth),
                   F64_RTOL if dtype == "float64" else F32_WELL_CONDITIONED_RTOL)


def test_cli_block_on_the_default_operator_matches_jax_f64():
    """The block driver with no --operator, as tests/test_cli.py:14-20."""
    compare_config(STENCIL_BLOCK | dict(dtype="float64"), F64_RTOL)


@pytest.mark.parametrize("start,rtol", [
    ("fixture", F32_SOLUTION_RTOL), ("orthonormal", F32_WELL_CONDITIONED_RTOL),
])
def test_cli_compensated_matches_jax(start, rtol):
    compare_config(COMPENSATED, rtol, start=start)


@pytest.mark.parametrize("fused", [None, True, False])
def test_cli_slice_matches_jax_f32(fused):
    compare_with_jax("float32", fused, F32_SOLUTION_RTOL)


@pytest.mark.parametrize("fused", [None, True, False])
def test_cli_slice_well_conditioned_matches_jax_f32(fused):
    compare_with_jax("float32", fused, F32_WELL_CONDITIONED_RTOL,
                     start="orthonormal")


@pytest.mark.parametrize("fused", [None, True, False])
def test_cli_slice_matches_jax_f64(fused):
    compare_with_jax("float64", fused, 1e-10)


def test_f32_noise_floor_of_the_fixture():
    """Why the fixture's f32 comparison is not held to 1e-5: the JAX
    package's own jacobi and lax eig backends disagree by more than that on
    this config, and the port's f32 answer lies as close to the f64 answer
    as JAX's do."""
    exact = np.asarray(jax_result("float64", None)["solution"])
    jax_f32 = [np.asarray(jax_result("float32", None, be)["solution"])
               for be in ("jacobi", "lax")]
    port = np.asarray(run(LanczosConfig(**SLICE, device="cpu"))["solution"])
    scale = np.abs(exact).max()
    assert np.abs(jax_f32[0] - jax_f32[1]).max() > 1e-5 * scale
    jax_err = max(np.abs(s - exact).max() for s in jax_f32)
    assert np.abs(port - exact).max() <= jax_err


def test_cli_reference_anchor_n10():
    """The JAX f32 run of this config gives solution ~ [0.96766, 0.95977,
    0.89650, 0.78864] and relative_error 3.0e-5; the f64 answer is
    [0.967674, 0.959794, 0.896525, 0.788665] (both measured on CPU)."""
    out = run(LanczosConfig(n_grid=10, m=6, n_col=4, operator="pallas", lc=20,
                            fused=True, fdtd_steps=1000, device="cpu"))
    ref = np.array([0.96766, 0.95977, 0.89650, 0.78864])
    assert np.abs(np.asarray(out["solution"]) - ref).max() <= F32_SOLUTION_RTOL
    assert out["relative_error"] < 1e-3


@pytest.mark.parametrize("start,rtol", [
    ("fixture", F32_SOLUTION_RTOL), ("orthonormal", F32_WELL_CONDITIONED_RTOL),
])
def test_cli_ell_matches_jax_f32(start, rtol):
    """--operator ell: the assembled A as gathered ELL on both sides."""
    compare_config(ELL, rtol, start=start)


def test_cli_ell_f64_matches_the_stencil_operator():
    """In f64 the assembled ELL operator and the matrix-free stencil are
    the same A: the CLI agrees to 1e-12, FDTD oracle included."""
    ell = run(LanczosConfig(**ELL, dtype="float64", device="cpu"))
    stencil = run(LanczosConfig(**(ELL | dict(operator="stencil")),
                                dtype="float64", device="cpu"))
    se, ss = np.asarray(ell["solution"]), np.asarray(stencil["solution"])
    assert np.abs(se - ss).max() <= F64_RTOL * np.abs(ss).max()
    assert abs(ell["relative_error"] - stencil["relative_error"]) <= F64_RTOL
    assert ell["n"] == stencil["n"] and ell["relative_error"] < 1e-3


@pytest.mark.parametrize("reorth,normalize", [
    ("full", "qr"), ("periodic", "sqrtm"), ("selective", "qr"),
])
def test_cli_block_reorth_matches_jax_f64(reorth, normalize):
    compare_config(STENCIL_BLOCK | dict(dtype="float64", reorth=reorth,
                                        normalize=normalize), F64_RTOL)


def test_cli_replace_dead_runs():
    """--replace-dead (its noise is not JAX's, so no JAX comparison): the
    FDTD oracle's bound, and the options JAX's checks require."""
    cfg = STENCIL_BLOCK | dict(dtype="float64", reorth="full", normalize="qr",
                               breakdown_eps=1e-8, replace_dead=True)
    out = run(LanczosConfig(**cfg, device="cpu"))
    assert out["relative_error"] < 1e-3
    with pytest.raises(ValueError, match="replace_dead"):
        run(LanczosConfig(**(cfg | dict(reorth="none")), device="cpu"))


def test_parser_flags_and_lc_default():
    args = build_parser().parse_args(
        ["-N", "4", "-m", "3", "--operator", "pallas", "--no-fused", "--device", "cpu"]
    )
    cfg = config_from_args(args)
    assert (cfg.n_grid, cfg.m, cfg.operator, cfg.fused, cfg.device) == (4, 3, "pallas", False, "cpu")
    assert build_parser().parse_args([]).device == "cuda"
    assert build_parser().parse_args([]).operator == "stencil"
    out = run(LanczosConfig(n_grid=3, m=2, operator="pallas", validate=False, device="cpu"))
    # the JAX CLI's default receiver (lanczos_tpu/cli.py:145-146)
    assert out["lc"] == 1 + random.Random(0).randrange(100)
    assert "relative_error" not in out


@pytest.mark.parametrize("kw,item", [
    (dict(operator="ell", devices=2), "needs --operator pallas"),
    (dict(operator="stencil", devices=4, profile_dir="trace"), "needs --operator pallas"),
    (dict(operator="pallas", devices=0), "N >= 1"),
])
def test_unported_flags_raise(kw, item):
    """--devices N > 1 runs the z-slab operator only (the JAX CLI ignores
    it elsewhere); the port raises before any rank starts."""
    with pytest.raises(ValueError, match=item):
        run(LanczosConfig(n_grid=3, m=2, device="cpu", **kw))


def test_profile_writes_a_chrome_trace(tmp_path):
    """--profile DIR --device cpu: torch.profiler over the Lanczos run
    writes DIR/lanczos_trace.json, and the result names the directory."""
    import json

    from lanczos_tpu_torch.cli import TRACE_FILE, main

    trace_dir = str(tmp_path / "prof")
    out = main(["-N", "3", "-m", "3", "--operator", "pallas", "--no-validate",
                "--device", "cpu", "--profile", trace_dir])
    assert out["profile_dir"] == trace_dir and len(out["solution"]) == 4
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)  # CPU ops of the run were recorded
    plain = run(LanczosConfig(n_grid=3, m=3, operator="pallas", validate=False,
                              device="cpu"))
    assert "profile_dir" not in plain and plain["solution"] == out["solution"]


def test_profile_trace_is_written_when_the_run_raises(tmp_path):
    from lanczos_tpu_torch.cli import TRACE_FILE

    trace_dir = str(tmp_path / "prof")
    with pytest.raises(ValueError, match="reorth"):
        run(LanczosConfig(n_grid=3, m=3, operator="pallas", reorth="bogus",
                          profile_dir=trace_dir, device="cpu"))
    assert os.path.getsize(os.path.join(trace_dir, TRACE_FILE)) > 0


@pytest.mark.parametrize("operator", ["stencil", "pallas"])
def test_vector_compensated_is_a_value_error(operator):
    """The JAX CLI silently ignores --compensated under --vector
    (lanczos_tpu/cli.py:180-193); the port refuses the pair."""
    with pytest.raises(ValueError, match="--compensated"):
        run(LanczosConfig(n_grid=3, m=2, block=False, compensated=True,
                          operator=operator, device="cpu"))


def test_device_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(LanczosConfig(n_grid=3, m=2, operator="pallas", device="cuda"))


def test_port_never_imports_jax():
    """Every module of the package, found by walking it (utils, native,
    benchmarks and examples included), imports without pulling in jax.
    `__main__` modules run their entry point when imported, so they are
    left out of the walk."""
    code = (
        "import sys, pkgutil, importlib; sys.path.insert(0, sys.argv[1]);"
        "import lanczos_tpu_torch as L;"
        "names = [m.name for m in pkgutil.walk_packages(L.__path__, 'lanczos_tpu_torch.')"
        " if not m.name.endswith('__main__')];"
        "[importlib.import_module(n) for n in names];"
        "[getattr(L, n) for n in L.__all__];"
        "need = {'lanczos_tpu_torch.' + n for n in ('cli', 'bench', 'probes', 'io',"
        " 'native', 'utils.timing', 'utils.bench_loop', 'benchmarks.kernel_bench',"
        " 'benchmarks.sweep_lanczos', 'benchmarks.convergence',"
        " 'benchmarks.suitesparse_scale', 'examples.eigsh_laplacian',"
        " 'examples.expm_maxwell', 'examples.fused_and_compensated',"
        " 'examples.windowed_general_matrix', 'examples.inplace_fast_paths',"
        " 'ops.kernels.stencil_kernel', 'methods.checkpoint', 'ops.window_ell',"
        " 'parallel.dist_operator', 'parallel.mesh', 'parallel.dist_windowed',"
        " 'parallel.dryrun', 'benchmarks.tune_windowed', 'benchmarks.plots')};"
        "assert need <= set(names), sorted(need - set(names));"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m);"
        "assert not any(m == 'lanczos_tpu' or m.startswith('lanczos_tpu.') for m in sys.modules)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # -I: no PYTHONPATH, user site or cwd, so only the package can pull jax in
    subprocess.run([sys.executable, "-I", "-c", code, root], check=True)
