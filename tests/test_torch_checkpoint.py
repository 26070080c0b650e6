"""Checkpoint/resume (`lanczos_tpu_torch.methods.checkpoint`) against the
JAX package's `lanczos_tpu.methods.checkpoint` and the port's own
monolithic runs, on the fixtures of tests/test_checkpoint.py, in f64 on
the CPU.

Tolerances: a chunked run does exactly the port's materialized
recurrence's operations, so it equals the monolithic run to f64 rounding
(1e-12 of scale) and an interrupted-and-resumed run equals the
uninterrupted chunked one exactly; against JAX, 1e-10 (other operation
orders in the small eigensolver and the products).

An interruption is honest: the partial file comes from a shorter run (or
from a run that stopped between chunks), never from a checkpoint whose j
was edited while its state vectors stayed those of a later step."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanczos_tpu.methods.checkpoint as jax_ck
from lanczos_tpu.models.maxwell import MaxwellOperator as JaxMaxwell
from lanczos_tpu.ops.operator import MatrixOperator as JaxMatrix
from lanczos_tpu_torch.methods import checkpoint as ck
from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
from lanczos_tpu_torch.models.maxwell import MaxwellOperator
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.models.rhs import gaussian_matrix_B
from lanczos_tpu_torch.ops.operator import MatrixOperator

SELF_RTOL = 1e-12
JAX_RTOL = 1e-10


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _laplacian():
    a = laplacian_2d_scipy(9, 8).toarray()
    return MatrixOperator(torch.from_numpy(a)), JaxMatrix(jnp.asarray(a)), a.shape[0]


def _block_fixture(kind):
    """The JAX block test's Maxwell fixture (N=3, p=3, the CLI's Gaussian
    start block, its alphas all zero) with its columns orthonormalized, or
    a 2-D Laplacian with a random start block, whose alphas are not zero.
    The raw Gaussian block has B^T B of condition 3.7e5, and there the
    port's and JAX's plain block_lanczos(fused=False) already differ by
    1.9e-10 of the trace's scale; with the same span orthonormalized, by
    1.5e-14."""
    if kind == "maxwell":
        top = MaxwellOperator.create(3, 3, 3, dtype=torch.float64, device="cpu")
        jop = JaxMaxwell.create(3, 3, 3, dtype=jnp.float64)
        b = np.asarray(gaussian_matrix_B(3, top.n, 3), np.float64)
        return top, jop, np.linalg.qr(b.T)[0].T.copy(), 17
    top, jop, n = _laplacian()
    return top, jop, np.random.default_rng(3).standard_normal((3, n)), 11


class _Crash(Exception):
    pass


def _crash_on_second_chunk(monkeypatch, module, name):
    """Make `module.name` (the per-chunk stepper) raise on its second
    call: the run stops after saving its first chunk, as a killed job
    would."""
    real = getattr(module, name)
    calls = []

    def once(*args, **kw):
        if calls:
            raise _Crash
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, once)


def _grow(c, m):
    """A checkpoint of a shorter run, its coefficient arrays grown to m
    (as tests/test_checkpoint.py grows the vector one)."""
    for name in ("alphas", "betas", "trace"):
        arr = getattr(c, name)
        big = np.zeros((m,) + arr.shape[1:], arr.dtype)
        big[: arr.shape[0]] = arr
        setattr(c, name, big)
    c.m = m
    return c


def test_chunked_matches_monolithic(rng, tmp_path):
    op, jop, n = _laplacian()
    b = rng.standard_normal(n)
    m, lc = 17, 5
    got = ck.vector_lanczos_checkpointed(op, torch.from_numpy(b), m, lc, chunk=4,
                                         path=str(tmp_path / "ck.npz"))
    ref = vector_lanczos(op, torch.from_numpy(b), m, lc, fused=False)
    jax = jax_ck.vector_lanczos_checkpointed(jop, jnp.asarray(b), m, lc, chunk=4)
    for name in ("alphas", "betas", "trace"):
        _close(getattr(got, name), getattr(ref, name), SELF_RTOL)
        _close(getattr(got, name), getattr(jax, name), JAX_RTOL)
    _close(got.beta_final, ref.beta_final, SELF_RTOL)
    saved = ck.LanczosCheckpoint.load(str(tmp_path / "ck.npz"))
    assert (saved.j, saved.m) == (m, m)


def test_resume_from_partial(rng, tmp_path):
    """A 6-step run's file, grown to m=12 and resumed, gives exactly the
    uninterrupted chunked run, and JAX's."""
    op, jop, n = _laplacian()
    b = torch.from_numpy(rng.standard_normal(n))
    m, lc = 12, 3
    path = str(tmp_path / "ck.npz")
    ck.vector_lanczos_checkpointed(op, b, 6, lc, chunk=3, path=path)
    part = ck.LanczosCheckpoint.load(path)
    assert part.j == 6
    _grow(part, m).save(path)
    resumed = ck.vector_lanczos_checkpointed(op, b, m, lc, chunk=3, path=path)
    whole = ck.vector_lanczos_checkpointed(op, b, m, lc, chunk=3,
                                           path=str(tmp_path / "whole.npz"))
    for name in ("alphas", "betas", "trace"):
        assert torch.equal(getattr(resumed, name), getattr(whole, name))
    done, ref = (ck.LanczosCheckpoint.load(str(tmp_path / f)) for f in ("ck.npz", "whole.npz"))
    assert done.j == m and np.array_equal(done.w, ref.w)
    jax = jax_ck.vector_lanczos_checkpointed(jop, jnp.asarray(b.numpy()), m, lc)
    _close(resumed.betas, jax.betas, JAX_RTOL)
    _close(resumed.trace, jax.trace, JAX_RTOL)


def test_fdtd_checkpointed(rng, tmp_path):
    op, jop, n = _laplacian()
    u0 = rng.standard_normal(n) * 1e-3
    ref = fdtd_vector(op, torch.from_numpy(u0), 1000, 1e-3)
    path = str(tmp_path / "fdtd.npz")
    got = ck.fdtd_checkpointed(op, torch.from_numpy(u0), 1000, 1e-3, chunk=256,
                               path=path)
    assert torch.equal(got, ref)
    _close(got, jax_ck.fdtd_checkpointed(jop, jnp.asarray(u0), 1000, 1e-3), JAX_RTOL)
    # resuming a finished run is a no-op
    again = ck.fdtd_checkpointed(op, torch.from_numpy(u0), 1000, 1e-3, chunk=256,
                                 path=path)
    assert torch.equal(again, got)
    # another nsteps or t_end starts afresh
    other = ck.fdtd_checkpointed(op, torch.from_numpy(u0), 10, 1e-3, path=path)
    assert torch.equal(other, fdtd_vector(op, torch.from_numpy(u0), 10, 1e-3))


def test_fdtd_block_on_the_folded_plane_resumes_exactly(monkeypatch, tmp_path):
    """The folded-plane operator steps through K5's plain version, two
    buffers ping-ponged across chunks (odd chunk lengths included): a run
    stopped after its first chunk and resumed equals fdtd_block exactly,
    and u0 is never written."""
    op = PallasMaxwellOperator.create(3, 3, 3, dtype=torch.float64, device="cpu")
    b = op.pack(torch.from_numpy(np.random.default_rng(0).standard_normal((2, op.n))))
    keep = b.clone()
    ref = fdtd_block(op, b, 60, 0.5)
    path = str(tmp_path / "fdtd.npz")
    _crash_on_second_chunk(monkeypatch, ck, "euler_steps")
    with pytest.raises(_Crash):
        ck.fdtd_checkpointed(op, b, 60, 0.5, chunk=23, path=path, block=True)
    with np.load(path) as z:
        assert int(z["step"]) == 23 and z["u"].shape == tuple(b.shape)
    monkeypatch.undo()
    got = ck.fdtd_checkpointed(op, b, 60, 0.5, chunk=23, path=path, block=True)
    assert torch.equal(got, ref) and torch.equal(b, keep)
    assert got.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("kind", ["maxwell", "laplacian"])
def test_block_chunked_matches_monolithic(kind, tmp_path):
    """block_lanczos_checkpointed == block_lanczos(fused=False) and JAX's
    block_lanczos_checkpointed: alphas, betas and trace (the Laplacian's
    alphas are nonzero, the Maxwell fixture's are zero)."""
    top, jop, b, lc = _block_fixture(kind)
    m = 9
    got = ck.block_lanczos_checkpointed(top, torch.from_numpy(b), m, lc, chunk=2,
                                        path=str(tmp_path / "blk.npz"))
    ref = block_lanczos(top, torch.from_numpy(b), m, lc, fused=False)
    jax = jax_ck.block_lanczos_checkpointed(jop, jnp.asarray(b), m, lc, chunk=2)
    if kind == "laplacian":
        assert np.abs(got.alphas.numpy()).max() > 1.0
    for name in ("alphas", "betas", "trace"):
        _close(getattr(got, name), getattr(ref, name), SELF_RTOL)
        _close(getattr(got, name), getattr(jax, name), JAX_RTOL)
    _close(got.beta_final, ref.beta_final, SELF_RTOL)


@pytest.mark.parametrize("kind", ["maxwell", "laplacian"])
def test_block_resume_from_a_shorter_run(kind, tmp_path):
    """The file of a 4-step run, grown to m=9 and resumed, gives exactly
    the uninterrupted chunked run: betas, trace, alphas and the final w."""
    top, _, b, lc = _block_fixture(kind)
    b = torch.from_numpy(b)
    m = 9
    path, whole = str(tmp_path / "part.npz"), str(tmp_path / "whole.npz")
    ck.block_lanczos_checkpointed(top, b, 4, lc, chunk=3, path=path)
    part = ck.BlockLanczosCheckpoint.load(path)
    assert part.j == 4
    _grow(part, m).save(path)
    resumed = ck.block_lanczos_checkpointed(top, b, m, lc, chunk=3, path=path)
    ref = ck.block_lanczos_checkpointed(top, b, m, lc, chunk=3, path=whole)
    for name in ("alphas", "betas", "trace"):
        assert torch.equal(getattr(resumed, name), getattr(ref, name))
    assert np.array_equal(ck.BlockLanczosCheckpoint.load(path).w,
                          ck.BlockLanczosCheckpoint.load(whole).w)


def test_jax_written_checkpoints_resume_in_the_port(monkeypatch, tmp_path):
    """Partial checkpoints written by lanczos_tpu (vector and block Lanczos
    grown from shorter runs; FDTD stopped after its first chunk) resume in
    lanczos_tpu_torch to JAX's uninterrupted results."""
    top, jop, n = _laplacian()
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n)
    vec = str(tmp_path / "vec.npz")
    jax_ck.vector_lanczos_checkpointed(jop, jnp.asarray(b), 6, 4, chunk=3, path=vec)
    _grow(jax_ck.LanczosCheckpoint.load(vec), 12).save(vec)
    got = ck.vector_lanczos_checkpointed(top, torch.from_numpy(b), 12, 4, path=vec)
    want = jax_ck.vector_lanczos_checkpointed(jop, jnp.asarray(b), 12, 4)
    for name in ("alphas", "betas", "trace"):
        _close(getattr(got, name), getattr(want, name), JAX_RTOL)

    top, jop, bb, lc = _block_fixture("laplacian")
    blk = str(tmp_path / "blk.npz")
    jax_ck.block_lanczos_checkpointed(jop, jnp.asarray(bb), 4, lc, chunk=3, path=blk)
    _grow(jax_ck.BlockLanczosCheckpoint.load(blk), 9).save(blk)
    got = ck.block_lanczos_checkpointed(top, torch.from_numpy(bb), 9, lc, path=blk)
    want = jax_ck.block_lanczos_checkpointed(jop, jnp.asarray(bb), 9, lc)
    for name in ("alphas", "betas", "trace"):
        _close(getattr(got, name), getattr(want, name), JAX_RTOL)

    u0 = rng.standard_normal(n) * 1e-3
    fd = str(tmp_path / "fdtd.npz")
    _crash_on_second_chunk(monkeypatch, jax_ck, "_fdtd_chunk_mv")
    with pytest.raises(_Crash):
        jax_ck.fdtd_checkpointed(jop, jnp.asarray(u0), 600, 1e-3, chunk=250, path=fd)
    monkeypatch.undo()
    got = ck.fdtd_checkpointed(top, torch.from_numpy(u0), 600, 1e-3, chunk=250,
                               path=fd)
    _close(got, jax_ck.fdtd_checkpointed(jop, jnp.asarray(u0), 600, 1e-3), JAX_RTOL)


def test_m_mismatch_is_a_value_error(tmp_path):
    op, _, n = _laplacian()
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n))
    path = str(tmp_path / "ck.npz")
    ck.vector_lanczos_checkpointed(op, b, 5, 0, path=path)
    with pytest.raises(ValueError, match="m=5, not m=7"):
        ck.vector_lanczos_checkpointed(op, b, 7, 0, path=path)
    ck.block_lanczos_checkpointed(op, torch.stack([b, b.flip(0)]), 5, 0, path=path,
                                  resume=False)
    with pytest.raises(ValueError, match="m=5, not m=6"):
        ck.block_lanczos_checkpointed(op, torch.stack([b, b.flip(0)]), 6, 0, path=path)


def test_a_failed_save_leaves_no_temp_file(monkeypatch, tmp_path):
    """_atomic_savez removes its temp file when writing fails, and the
    previous checkpoint stays as it was."""
    path = str(tmp_path / "ck.npz")
    ck._atomic_savez(path, u=np.arange(3.0))

    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        ck._atomic_savez(path, u=np.arange(5.0))
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["ck.npz"]
    with np.load(path) as z:
        assert np.array_equal(z["u"], np.arange(3.0))


def test_checkpoint_dataclasses_round_trip(tmp_path):
    c = ck.BlockLanczosCheckpoint(j=2, m=3, alphas=np.ones((3, 2, 2)),
                                  betas=np.zeros((3, 2, 2)), trace=np.ones((3, 2)),
                                  q_prev=np.ones((2, 5)), w=np.arange(10.0).reshape(2, 5))
    path = str(tmp_path / "b.npz")
    c.save(path)
    back = ck.BlockLanczosCheckpoint.load(path)
    assert (back.j, back.m) == (2, 3)
    for f in dataclasses.fields(c):
        assert np.array_equal(np.asarray(getattr(back, f.name)),
                              np.asarray(getattr(c, f.name)))
    # the JAX package reads it as its own
    jback = jax_ck.BlockLanczosCheckpoint.load(path)
    assert jback.j == 2 and np.array_equal(jback.w, c.w)


def test_jax_written_folded_plane_checkpoints_resume_in_the_port(monkeypatch, tmp_path):
    """The folded-plane state, (p, 6, Zc, P) in both packages: a block
    Lanczos checkpoint and an FDTD one written by lanczos_tpu (Pallas in
    interpret mode) resume in lanczos_tpu_torch to JAX's uninterrupted
    results (the FDTD steps through K5's plain version here)."""
    from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp

    jop = JaxOp.create(3, 3, 3, dtype=jnp.float64)
    top = PallasMaxwellOperator.create(3, 3, 3, dtype=torch.float64, device="cpu")
    b = top.pack(torch.from_numpy(np.random.default_rng(4).standard_normal((2, top.n))))
    bj = jnp.asarray(b.numpy())

    blk = str(tmp_path / "blk.npz")
    jax_ck.block_lanczos_checkpointed(jop, bj, 3, 0, chunk=2, path=blk,
                                      trace_fn=jop.trace_fn(20))
    part = _grow(jax_ck.BlockLanczosCheckpoint.load(blk), 5)
    assert part.w.shape == tuple(b.shape)
    part.save(blk)
    got = ck.block_lanczos_checkpointed(top, b, 5, 0, path=blk,
                                        trace_fn=top.trace_fn(20))
    want = jax_ck.block_lanczos_checkpointed(jop, bj, 5, 0, trace_fn=jop.trace_fn(20))
    for name in ("alphas", "betas", "trace"):
        _close(getattr(got, name), getattr(want, name), JAX_RTOL)

    fd = str(tmp_path / "fdtd.npz")
    _crash_on_second_chunk(monkeypatch, jax_ck, "_fdtd_chunk_mm")
    with pytest.raises(_Crash):
        jax_ck.fdtd_checkpointed(jop, bj, 40, 0.5, chunk=15, path=fd, block=True)
    monkeypatch.undo()
    got = ck.fdtd_checkpointed(top, b, 40, 0.5, chunk=15, path=fd, block=True)
    _close(got, jax_ck.fdtd_checkpointed(jop, bj, 40, 0.5, block=True), JAX_RTOL)
