"""The port's timing layer (lanczos_tpu_torch/utils/timing.py,
utils/bench_loop.py) on the CPU: its roofline model equals the JAX
package's, every protocol returns finite positive seconds, and the chained
forms feed each call its predecessor's output.  On the CPU the host clock
times the calls; the card's CUDA-event path runs in chip_smoke.py."""

import math

import pytest
import torch

from lanczos_tpu.utils import timing as jtiming
from lanczos_tpu_torch.utils import bench_loop, timing


@pytest.mark.parametrize("seconds,nbytes,flops", [(1e-3, 4e9, 2e9), (0.25, 1.0, 0.0),
                                                  (3.0, 123456789.0, 987654321.0)])
def test_roofline_equals_jax(seconds, nbytes, flops):
    got, want = timing.roofline(seconds, nbytes, flops), jtiming.roofline(seconds, nbytes, flops)
    assert (got.seconds, got.bytes_moved, got.flops) == (want.seconds, want.bytes_moved, want.flops)
    assert got.gbps == want.gbps and got.gflops == want.gflops
    r = timing.Roofline(seconds, nbytes, flops)
    assert r.gbps == want.gbps and r.gflops == want.gflops


def _finite_positive(s):
    return isinstance(s, float) and math.isfinite(s) and s > 0


def test_protocols_return_finite_positive_seconds():
    x = torch.randn(4, 20_000)
    z = torch.randn(4, 20_000)
    assert _finite_positive(timing.benchmark_best(lambda a, b: a @ b.T, x, z, tests=2, reps=3))
    assert _finite_positive(timing.benchmark_chained(lambda y: 0.5 * y, x, tests=2, reps=3))
    assert _finite_positive(bench_loop.slope_time(lambda a, b: a @ b.T, x, z,
                                                  min_delta_s=1e-3))
    assert _finite_positive(bench_loop.slope_time_chain(lambda y: 1.0 - y, x, damp=None,
                                                        min_delta_s=1e-3))
    assert _finite_positive(bench_loop.slope_time_chain(lambda y, s: y * s, x, 0.5,
                                                        min_delta_s=1e-3))


def _recording_step():
    """A self-map that records (id of its input, id of its output)."""
    calls = []

    def step(y, *extra):
        out = y * 1.0
        calls.append((id(y), id(out), y))
        return out

    return step, calls


def _assert_chained(calls, x0):
    """Every call takes the previous call's output, or starts a chain at
    x0 (a new batch or chain length)."""
    assert len(calls) > 2
    for (_, prev_out, _), (inp, _, y) in zip(calls, calls[1:]):
        assert inp == prev_out or y is x0


def test_benchmark_chained_feeds_each_call_its_predecessor():
    x0 = torch.ones(8)
    step, calls = _recording_step()
    timing.benchmark_chained(step, x0, tests=2, reps=4)
    _assert_chained(calls, x0)
    # the first call is the warm-up, then each batch restarts from x0
    assert sum(1 for c in calls if c[2] is x0) == 3


def test_slope_time_chain_feeds_each_call_its_predecessor():
    x0 = torch.ones(8)
    step, calls = _recording_step()
    bench_loop.slope_time_chain(step, x0, damp=None, k1=2, k2=4, trials=2,
                                min_delta_s=0.0)
    _assert_chained(calls, x0)


def test_slope_time_chain_damps_between_steps():
    seen = []

    def step(y):
        seen.append(float(y[0]))
        return y

    bench_loop.slope_time_chain(step, torch.ones(1), damp=0.5, k1=1, k2=3,
                                trials=1, min_delta_s=0.0)
    assert seen[:2] == [1.0, 1.0] and seen[2:5] == [1.0, 0.5, 0.25]


def test_slope_escalates_until_the_delta_clears():
    counts = []

    def op(x):
        counts.append(1)
        return x

    # an op too fast to resolve climbs to k2_max
    bench_loop.slope_time(op, torch.ones(1), k1=2, k2=4, trials=1, k2_max=256,
                          min_delta_s=10.0)
    assert bench_loop._escalating_ks(2, 4, 256) == [4, 32, 256]
    assert len(counts) == 2 + (2 + 4) + (2 + 32) + (2 + 256)


def test_find_device_reads_tensors_modules_and_sequences():
    from lanczos_tpu_torch.ops.operator import MatrixOperator

    assert timing.find_device(3, MatrixOperator(torch.eye(2))) == torch.device("cpu")
    assert timing.find_device(None, [torch.ones(1)]) == torch.device("cpu")
    assert timing.find_device("x") == torch.device("cpu")
