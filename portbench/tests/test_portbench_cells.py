"""Every cell driven through the harness on the CPU at a size a test can
hold (the port's kernel wrappers run their plain versions there): a sound
run comes out correct; its control, the reference in TF32 in the
program's place, reads above a limit; and a run with the program broken
underneath comes out not correct, once for each fault the cell can have:
a step that returns its state unchanged, half of the batch left out with
the mean of the rest in its place, an answer altered where it is made,
and an operator 1% off.
(No cell spans chips yet.  The multi-chip counterpart, one rank that
leaves out its exchange, is `test_portbench_ranks.py`'s, on a test-only
SPMD probe.)"""

from __future__ import annotations

import time

import pytest
import torch

from portbench.control import control_readings
from portbench.run import run_cell
from portbench.tests.cells import tiny_cell

CELLS = ["maxwell160-block-expm", "maxwell160-fdtd", "banded10m-block-eigsh"]
SEED = 2**33 + 17  # seeds may take more than 32 bits


def run(cell, seed=SEED):
    return run_cell(cell, seed, 0.3, False, device="cpu", t0=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(res)[-1] == "checks"
    cell = tiny_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    readings = control_readings(cell, SEED, 20, torch.device("cpu"))
    assert any(readings[k] > v for k, v in cell["limits"].items()), readings


def _unchanged(monkeypatch, name):
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.ops.window_ell import PaddedWindowedOperator

    if name == "maxwell160-fdtd":
        def step(self, u, out):
            return out.copy_(u)
        monkeypatch.setattr(PallasMaxwellOperator, "fdtd_step", step)
    elif name == "banded10m-block-eigsh":
        monkeypatch.setattr(PaddedWindowedOperator, "mm", lambda self, x: x.clone())
    else:
        monkeypatch.setattr(PallasMaxwellOperator, "mm", lambda self, x: x.clone())


def _half_batch(monkeypatch, name):
    from lanczos_tpu_torch.methods import eigs, expm_action, fdtd

    if name == "maxwell160-block-expm":
        orig = expm_action.block_lanczos_expm_action

        def action(a, b, *args, **kw):
            h = b.shape[0] // 2
            sol = orig(a, b[:h], *args, **kw)
            return torch.cat([sol, sol.mean().expand(b.shape[0] - h)])
        monkeypatch.setattr(expm_action, "block_lanczos_expm_action", action)
    elif name == "maxwell160-fdtd":
        orig = fdtd.fdtd_block

        def integrate(a, b, *args):
            h = b.shape[0] // 2
            u = orig(a, b[:h], *args)
            return torch.cat([u, u.mean(0, keepdim=True).expand((b.shape[0] - h,) + u.shape[1:])])
        monkeypatch.setattr(fdtd, "fdtd_block", integrate)
    else:
        orig = eigs.block_lanczos_eigsh

        def eigsh(*args, **kw):
            vals, vecs, bounds = orig(*args, **kw)
            h = (vals.shape[0] + 1) // 2
            vals, vecs = vals.clone(), vecs.clone()
            vals[h:] = vals[:h].mean()
            vecs[:, h:] = vecs[:, :h].mean(1, keepdim=True)
            return vals, vecs, bounds
        monkeypatch.setattr(eigs, "block_lanczos_eigsh", eigsh)


def _altered(monkeypatch, name):
    """The first answer made, one entry of it 1% off."""
    from lanczos_tpu_torch.methods import eigs, expm_action, fdtd

    if name == "banded10m-block-eigsh":
        module, attr = eigs, "block_lanczos_eigsh"
    elif name == "maxwell160-fdtd":
        module, attr = fdtd, "fdtd_block"
    else:
        module, attr = expm_action, "block_lanczos_expm_action"
    orig = getattr(module, attr)
    calls = []

    def altered(*args, **kw):
        out = orig(*args, **kw)
        calls.append(1)
        first = out[0] if isinstance(out, tuple) else out
        if len(calls) == 1:  # a whole column of a state, else one value
            (first[0] if first.ndim > 1 else first.view(-1)[:1]).mul_(1.01)
        return out
    monkeypatch.setattr(module, attr, altered)


def _operator_off(monkeypatch, name):
    """Every product with the operator 1% too large.  At an E1 receiver
    the expm answer moves by about 2% of 2% (A enters it at second order
    there), under its limit; at an H2 receiver it moves by 1%."""
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.ops.window_ell import PaddedWindowedOperator

    if name == "banded10m-block-eigsh":
        mm = PaddedWindowedOperator.mm
        monkeypatch.setattr(PaddedWindowedOperator, "mm", lambda self, x: mm(self, x) * 1.01)
    else:
        create = PallasMaxwellOperator.create.__func__
        monkeypatch.setattr(PallasMaxwellOperator, "create", classmethod(
            lambda cls, *args, **kw: create(cls, *args, **kw).scaled(1.01)))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered,
          "operator_off": _operator_off}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch, name)
    res = run(tiny_cell(name))
    assert not res["correct"], res["checks"]


def test_single_vector_path():
    """The expm driver at p = 1 (`lanczos_expm_action`), which a cell of
    its own can take with a traffic file alone: correct, and an answer
    altered where it is made is not."""
    cell = tiny_cell("maxwell160-block-expm")
    cell["traffic"].update(p=1, m=8)
    assert run(cell)["correct"]
    with pytest.MonkeyPatch.context() as mp:
        from lanczos_tpu_torch.methods import expm_action

        orig = expm_action.lanczos_expm_action
        mp.setattr(expm_action, "lanczos_expm_action",
                   lambda *a, **k: orig(*a, **k) * 1.01)
        assert not run(cell)["correct"]
