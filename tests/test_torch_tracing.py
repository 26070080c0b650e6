"""The port's spans and counters (`lanczos_tpu_torch/utils/tracing.py`).

On the CPU: with no profiler recording a span makes no torch call; under
a CPU `torch.profiler` each layer's span appears as often as the code
makes the work it brackets, nested in its caller's; the counters count
what the host did (a graph replay one launch, a recording nothing); their
profiled part holds only what ran while a profiler recorded.  On the card
(`-m cuda`): the host launches, captures and TSQR calls of the
benchmark's three requests, at small sizes."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from lanczos_tpu_torch.methods import eigs, expm_action, fdtd
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.tsqr import tsqr_plan
from lanczos_tpu_torch.ops.window_ell import PaddedWindowedOperator, windowed_from_scipy
from lanczos_tpu_torch.utils import graphs, tracing

M = 5


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


def _maxwell(p, device="cpu", n=4, dtype=torch.float64):
    op = PallasMaxwellOperator.create(n, n, n, dtype=dtype, device=device)
    x = np.random.default_rng(5).standard_normal((p, op.n))
    return op, op.pack(torch.from_numpy(x).to(dtype).to(device))


def _banded(p, n=600, device="cpu", dtype=torch.float64):
    rng = np.random.default_rng(7)
    offsets = (0, 1, 7, 64)
    diags = [4.0 + rng.random(n)] + [0.3 * rng.random(n - k) for k in offsets[1:]]
    a = sp.diags(diags + diags[1:], list(offsets) + [-k for k in offsets[1:]],
                 format="csr")
    base = windowed_from_scipy(a, dtype=dtype, reorder="none", device=device)
    x = rng.standard_normal((p, n))
    return PaddedWindowedOperator(base), base.pack(torch.from_numpy(x).to(dtype).to(device))


def _block_expm(op, b, fused=None, m=M):
    return expm_action.block_lanczos_expm_action(op, b, m, 1.0, 0, fused=fused,
                                                 trace_fn=op.trace_fn(3))


def _eigsh(op, b, m=M, **kw):
    vals, vecs, _ = eigs.block_lanczos_eigsh(op, b, m, 3, compute_vectors=True, **kw)
    return eigs.ritz_residuals(op, vals, vecs)


# the benchmark's eigsh traffic: TSQR in every step and again in the cleanup
QR_FULL = dict(reorth="full", normalize="qr", breakdown_eps=1e-4, replace_dead=True,
               eig_backend="newton")


def _spans(fn):
    """The port's spans a profiled call of fn makes: [(name, parents)],
    parents the names of the enclosing ranges, innermost first."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if e.name.startswith("lt."):
            parents, up = [], e.cpu_parent
            while up is not None:
                parents.append(up.name)
                up = up.cpu_parent
            out.append((e.name, parents))
    return out


def _names(spans):
    names = {}
    for name, _ in spans:
        names[name] = names.get(name, 0) + 1
    return names


def test_span_off_is_one_shared_no_op():
    assert not tracing.recording()
    assert tracing.span("lt.a") is tracing.span("lt.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        assert tracing.span("lt.a") is not tracing.span("lt.a")


@pytest.mark.parametrize("call", ["block_expm", "eigsh", "fdtd"])
def test_no_torch_call_per_span_when_no_profiler_records(monkeypatch, call):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    if call == "block_expm":
        op, b = _maxwell(2)
        _block_expm(op, b, fused=True)
        _block_expm(op, b, fused=False)
    elif call == "eigsh":
        op, b = _banded(3)
        _eigsh(op, b, **QR_FULL)
    else:
        op, b = _maxwell(2)
        fdtd.fdtd_block(op, b, 7, 1.0)
    assert tracing.COUNTERS and not tracing.PROFILED


@pytest.mark.parametrize("fused", [True, False])
def test_block_expm_spans(fused):
    op, b = _maxwell(2)
    spans = _spans(lambda: _block_expm(op, b, fused=fused))
    names = _names(spans)
    assert names["lt.expm.block"] == 1 and names["lt.expm.project"] == 1
    assert names["lt.lanczos.prologue"] == 1
    assert names["lt.lanczos.step"] == M - 1
    # one product a step and the prologue's (K1, or K4 on the mono step)
    assert names["lt.op.apply"] == M
    if fused:
        # the p x p algebra before and after each step's kernels, and beta_m's
        assert names["lt.lanczos.coeffs"] == 2 * (M - 1) + 1
        assert names["lt.smalleig.sqrtm"] == M + 1
    for name, parents in spans:
        if name != "lt.expm.block":
            assert "lt.expm.block" in parents, name
        if name == "lt.op.apply":
            assert parents[0] in ("lt.lanczos.prologue", "lt.lanczos.step")
    assert "lt.tsqr" not in names
    assert tracing.PROFILED["lanczos.steps"] == M - 1


def test_vector_expm_spans():
    op, b = _maxwell(1)
    spans = _spans(lambda: expm_action.lanczos_expm_action(
        op, b[0], M, 1.0, 0, reorth="full", trace_fn=op.trace_fn(3)))
    names = _names(spans)
    assert names["lt.expm.vector"] == 1 and names["lt.lanczos.step"] == M - 1
    # the full reorth's CGS2 once a step
    assert names["lt.lanczos.reorth"] == M - 1


@pytest.mark.parametrize("opts,tsqrs", [
    # the start block, each later step, and beta_m's R
    (dict(reorth="none", normalize="qr"), M + 1),
    # and the cleanup's re-QR in every step (breakdown_eps > 0)
    (QR_FULL, 2 * M),
])
def test_eigsh_spans_and_tsqr_count(opts, tsqrs):
    op, b = _banded(3)
    spans = _spans(lambda: _eigsh(op, b, **opts))
    names = _names(spans)
    assert names["lt.eigsh.block"] == 1 and names["lt.eigsh.ritz"] == 1
    assert names["lt.eigsh.residuals"] == 1
    assert names["lt.lanczos.step"] == M - 1
    assert names["lt.tsqr"] == tsqrs
    assert tracing.PROFILED["tsqr.calls"] == tsqrs == tracing.COUNTERS["tsqr.calls"]
    # the products: the prologue's, one a step, the residuals' one
    assert names["lt.op.apply"] == M + 1
    assert names.get("lt.lanczos.reorth", 0) == (2 * (M - 1) if opts is QR_FULL else 0)
    # each CGS2 call counted; the CPU runs its plain version
    assert tracing.COUNTERS.get("cgs2.calls", 0) == names.get("lt.lanczos.reorth", 0)
    assert "cgs2.kernel" not in tracing.COUNTERS
    for name, parents in spans:
        if name == "lt.tsqr":
            assert "lt.eigsh.block" in parents


def test_fdtd_span_once_and_steps_counted():
    op, b = _maxwell(2)
    names = _names(_spans(lambda: fdtd.fdtd_block(op, b, 9, 1.0)))
    assert names == {"lt.fdtd": 1}
    assert tracing.PROFILED == {"fdtd.steps": 9}


def test_profiled_counts_only_while_recording():
    tracing.count("tsqr.calls")
    recorded = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1)) as prof:
        for _ in range(3):
            tracing.count("tsqr.calls", 2)
            recorded.append(tracing.recording())
            prof.step()
    tracing.count("tsqr.calls")
    assert recorded == [False, True, True]
    assert tracing.counters() == {"tsqr.calls": 8}
    assert tracing.profiled() == {"tsqr.calls": 4}


class FakeGraph:
    def replay(self):
        pass


def test_replay_is_one_host_launch_and_recording_counts_nothing():
    tracing.count("launches.host", 5)
    before = tracing.counters()

    def record():
        build.LAUNCHES["fdtd_step"] += 64
        tracing.count("launches.host", 64)
        tracing.count("fdtd.steps", 64)

    counts = graphs.counted(record)
    assert counts == {"fdtd_step": 64}
    assert tracing.counters() == before
    build.reset_launches()
    graphs.Replay(FakeGraph(), counts).replay(7)
    assert build.LAUNCHES["fdtd_step"] == 7 * 64
    assert tracing.counters() == {"launches.host": 5 + 7, "graphs.replays": 7}
    build.reset_launches()


def test_counted_restores_the_profiled_counts_too():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("launches.host")
        graphs.counted(lambda: tracing.count("launches.host", 9))
        graphs.Replay(FakeGraph(), {}).replay(2)
    assert tracing.profiled() == {"launches.host": 3, "graphs.replays": 2}


def test_a_launch_counts_its_kernels_as_host_launches(monkeypatch):
    class Lib:
        @staticmethod
        def lt_fake(*args):
            return 0

    monkeypatch.setattr(build, "library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    build.launch("windowed_spmm", torch.zeros(2), "lt_fake", count=3)
    assert tracing.counters() == {"launches.host": 3}
    build.reset_launches()


# -- on the card: the benchmark's requests at small sizes ---------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels launch only there")
    return torch.device("cuda")


def _host_counts(fn):
    fn()  # loads the kernels and every plan
    torch.cuda.synchronize()
    tracing.reset()
    fn()
    torch.cuda.synchronize()
    return tracing.counters()


@pytest.mark.cuda
def test_block_expm_host_launches_on_the_card(card):
    """p = 4, m = 6: prologue 5 (K3, S1, K2, K1, K3), peeled step 4 (S1,
    K2, K1, K3), 4 mono steps of 3 (S1, K2, K4), beta_m's S1."""
    op, b = _maxwell(4, device=card, n=32, dtype=torch.float32)
    got = _host_counts(lambda: _block_expm(op, b, fused=True, m=6))
    assert got["launches.host"] == 22
    assert "graphs.captures" not in got and got["lanczos.steps"] == 5


@pytest.mark.cuda
def test_fdtd_host_launches_on_the_card(card):
    """500 steps: 1 eager K5, 7 replays of 64, 51 eager K5."""
    op, b = _maxwell(4, device=card, n=32, dtype=torch.float32)
    got = _host_counts(lambda: fdtd.fdtd_block(op, b, 500, 1.0))
    assert got == {"launches.host": 1 + 7 + 51, "graphs.captures": 1,
                   "graphs.replays": 7, "fdtd.steps": 500}


@pytest.mark.cuda
def test_eigsh_host_launches_on_the_card(card):
    """p = 8, m = 12 with the benchmark's options: 12 products (K8) and
    the residuals' one; 24 TSQRs on T1, the last (beta_m's) R alone; 22
    CGS2 calls on C1 (the q-side cleanup against j blocks and the
    residual's pass against j + 1, j = 1..11), three launches each."""
    op, b = _banded(8, n=20_000, device=card, dtype=torch.float32)
    got = _host_counts(lambda: _eigsh(op, b, m=12, **QR_FULL))
    plan = tsqr_plan(b[0].numel(), 8, 4)
    t1 = 23 * plan.launches() + plan.launches(False)
    assert got["launches.host"] == 13 + t1 + 22 * 3
    assert got["tsqr.calls"] == got["tsqr.kernel"] == 24
    assert got["cgs2.calls"] == got["cgs2.kernel"] == 22
