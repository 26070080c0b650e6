"""`lanczos_tpu_torch/utils/graphs.py` and FDTD's replayed K5 loop
(`methods/fdtd.py`) on the CPU: the split of a loop into an eager head,
whole replays and an eager tail, the launch counts a replay adds, and
`euler_steps` against the JAX package's `fdtd_block` and `fdtd_vector`
at a step count the graph's chunk does not divide.  A CUDA graph records
only on the card: here a stand-in "graph" reruns what was recorded, which
is what a replay launches, so the loop's ping-pong over its two buffers
runs as it does there.  The card tests (tests/test_torch_kernels.py,
`-m cuda`) hold the real replay to the eager loop bit for bit.

Tolerances: f64 to 1e-12 of the state's scale against JAX (K5's plain
version and JAX's step round in other orders); the replayed loop against
the eager one exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods.fdtd import fdtd_block as jax_fdtd_block
from lanczos_tpu.methods.fdtd import fdtd_vector as jax_fdtd_vector
from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu_torch.methods import fdtd
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.utils import graphs

CHUNK = fdtd.GRAPH_CHUNK


@pytest.mark.parametrize("nsteps,chunk,want", [
    (0, 4, (0, 0, 0)), (1, 4, (1, 0, 0)), (4, 4, (1, 0, 3)), (5, 4, (1, 1, 0)),
    (12, 4, (1, 2, 3)), (1000, 256, (1, 3, 231)), (10**6, 256, (1, 3906, 63)),
])
def test_split_steps(nsteps, chunk, want):
    head, replays, tail = graphs.split_steps(nsteps, chunk)
    assert (head, replays, tail) == want
    assert head + replays * chunk + tail == nsteps


@pytest.mark.parametrize("chunk", [0, 1, 3, 255])
def test_split_steps_refuses_an_odd_chunk(chunk):
    with pytest.raises(ValueError, match="even"):
        graphs.split_steps(10, chunk)


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_recording_adds_no_launch_and_each_replay_adds_the_recorded_ones():
    build.reset_launches()
    build.LAUNCHES["block_mix"] = 5

    def record():  # what a recorded sequence's wrappers count
        build.LAUNCHES["fdtd_step"] += 4
        build.LAUNCHES["apply_stencil_pair"] += 1

    counts = graphs.counted(record)
    assert counts == {"fdtd_step": 4, "apply_stencil_pair": 1}
    assert {k: c for k, c in build.LAUNCHES.items() if c} == {"block_mix": 5}
    keep = (torch.zeros(2),)
    loop = graphs.Replay(FakeGraph(), counts, keep)
    loop.replay(3)
    assert loop.graph.replays == 3 and loop.keep is keep
    assert {k: c for k, c in build.LAUNCHES.items() if c} == {
        "block_mix": 5, "fdtd_step": 12, "apply_stencil_pair": 3}
    build.reset_launches()


def test_a_failed_recording_raises_and_leaves_the_counts():
    build.reset_launches()

    def record():
        build.LAUNCHES["fdtd_step"] += 1
        raise RuntimeError("fdtd_step: CUDA error 900 at launch")

    with pytest.raises(RuntimeError, match="900"):
        graphs.counted(record)
    assert all(c == 0 for c in build.LAUNCHES.values())


class Rerun:
    """A stand-in graph that reruns the recorded steps on a replay (a
    CUDA graph launches them): recording itself runs nothing."""

    def __init__(self, record):
        self.record = record

    def replay(self):
        self.record()


@pytest.fixture
def replayed(monkeypatch):
    """euler_steps takes its graph route on the CPU, each capture a
    Rerun counted as GRAPH_CHUNK K5 launches; returns the captures."""
    captures = []

    def capture(record, device, keep=()):
        captures.append(keep)
        return graphs.Replay(Rerun(record), {"fdtd_step": CHUNK}, keep)

    monkeypatch.setattr(fdtd, "_replayable", lambda u: True)
    monkeypatch.setattr(graphs, "capture", capture)
    return captures


def _fixture(p, seed=3):
    jop = JaxOp.create(3, 3, 3, dtype=jnp.float64)
    top = PallasMaxwellOperator.create(3, 3, 3, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(seed).standard_normal((p, top.n))
    return jop, top, top.pack(torch.from_numpy(x))


@pytest.mark.parametrize("p", [1, 2])
def test_euler_steps_with_a_tail_matches_jax(p):
    """CHUNK + 3 steps (the CPU loop, eager) against JAX's fori_loop."""
    nsteps = CHUNK + 3
    jop, top, b = _fixture(p)
    if p == 1:
        want = np.asarray(jax_fdtd_vector(jop, jnp.asarray(b[0].numpy()), nsteps, 1.0))
        got = fdtd.fdtd_vector(top, b[0].clone(), nsteps, 1.0)
    else:
        want = np.asarray(jax_fdtd_block(jop, jnp.asarray(b.numpy()), nsteps, 1.0))
        got = fdtd.fdtd_block(top, b, nsteps, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("nsteps", [2 * CHUNK + 3, CHUNK + 1, CHUNK, 1])
def test_replayed_steps_equal_the_eager_loop(replayed, nsteps):
    """The graph route: a first eager step, whole replays, an eager tail,
    every step once in LAUNCHES' count (here CHUNK a replay), u0 only
    read, the result bit-equal to graph=False."""
    _, top, b = _fixture(2)
    keep = b.clone()
    dt = torch.tensor(1.0 / nsteps, dtype=torch.float64)
    eager = fdtd.euler_steps(top, b, nsteps, dt, block=True, graph=False)
    assert not replayed
    build.reset_launches()
    got = fdtd.euler_steps(top, b, nsteps, dt, block=True)
    head, replays, tail = graphs.split_steps(nsteps, CHUNK)
    assert len(replayed) == (1 if replays else 0)
    assert build.LAUNCHES["fdtd_step"] == replays * CHUNK
    assert torch.equal(got, eager) and torch.equal(b, keep)
    assert got.data_ptr() != b.data_ptr()


def test_replayed_chunks_continue_in_the_same_buffers(replayed):
    """checkpoint.py's way: euler_steps chunk by chunk with one pair of
    bufs equals one uninterrupted run, bit for bit."""
    _, top, b = _fixture(1)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    whole = fdtd.euler_steps(top, b, 3 * CHUNK, dt, block=True, graph=False)
    bufs = (torch.empty_like(b), torch.empty_like(b))
    u = b
    for k in (CHUNK + 5, 2 * CHUNK - 5):
        u = fdtd.euler_steps(top, u, k, dt, block=True, bufs=bufs)
        assert any(u.data_ptr() == x.data_ptr() for x in bufs)
    assert torch.equal(u, whole) and len(replayed) == 2
