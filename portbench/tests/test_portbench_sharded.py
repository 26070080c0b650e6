"""The four-card cell `banded134m-windowed-eigsh` cut to 12,000 rows (as
`cells.tiny_cell` cuts the banded cell), driven as the benchmark runs it
(`python -m portbench.run`, rank 0 in a process of its own) on the CPU
over gloo at two and four ranks, and, marked cuda, on four cards at
4,194,304 rows (`python -m pytest portbench/tests -m cuda -q -s`).

A sound run is correct, untraced and traced, and a traced one reads the
collectives the port's mesh runs; the sharded plain reference (float64
over the ranks) gives the Ritz values of `reference/eigsh.py` on the
whole matrix; the cell's control, the reference in TF32 run as the
program, is not correct; and so is the program with each fault of
`sharded_faults.py` planted in its halo exchange: a spike's row dropped,
the row next to each shard edge dropped, the whole exchange dropped, and
a halo left from the previous product."""

from __future__ import annotations

import uuid

import pytest
import torch

from portbench.ranks import Group
from portbench.run import load_cell
from portbench.tests.cells import BANDED_ROWS
from portbench.tests.test_portbench_ranks import check_sound, run_probe

CELL = "banded134m-windowed-eigsh"
CARD_ROWS = 2**22
# the collectives of one request (p = 8, m = 12, full re-orthogonalization,
# QR normalization with breakdown_eps > 0): a halo exchange for each of the
# m products and the residuals'; an all-reduce for each Gram (m), the two
# passes of each step's q-side and residual-side CGS2 (m - 1 steps), the
# trace and the residuals' norms; an all-gather for each sharded TSQR (the
# start block, two a step, beta_m).  replace_dead asks for no flag: the
# cleanup runs every step anyway
COLLECTIVES = 13 + (12 + 2 * 11 + 2 * 11 + 1 + 1) + (1 + 2 * 11 + 1)


def sharded_cell(world: int, rows: int = BANDED_ROWS, driver: str | None = None,
                 fault: str | None = None) -> dict:
    cell = load_cell(CELL)
    cell["config"].update(rows=rows)
    cell["config"]["deployment"] = dict(cell["config"]["deployment"], ranks=world)
    cell.update(name=f"{CELL}-{uuid.uuid4().hex[:12]}", chips=world)
    if driver:
        cell["modules"] = {"drivers": driver}
    if fault:
        cell["traffic"]["fault"] = fault
    return cell


@pytest.mark.parametrize("world", [2, 4])
def test_sound_run_is_correct(tmp_path, world):
    res = check_sound(run_probe(tmp_path, sharded_cell(world)), world)
    assert set(res["metrics"]) == {"solve_ms.eigsh", "setup_s"}
    # float32's rounding over a row's 11 terms, well under the limit
    apply = res["checks"]["apply_rel_err"]
    assert 0.0 < apply["value"] < apply["limit"] / 10, apply


def test_traced_run_reads_the_mesh(tmp_path):
    res = check_sound(run_probe(tmp_path, sharded_cell(2), trace=1), 2)
    assert res["metrics"]["collectives.eigsh"]["value"] == COLLECTIVES
    assert res["metrics"]["host_launches.eigsh"]["value"] == 0.0  # the CPU launches no kernel


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_reference_is_the_whole_reference(world):
    """At 4 ranks a shard (3,072 rows) is narrower than the halo (4,999):
    the reference's exchange reaches two ranks away."""
    from lanczos_tpu_torch.parallel import launch

    got = launch.run(_sharded_ritz, world, device="cpu", timeout=240.0)
    want = _whole_ritz()
    for vals in got:
        torch.testing.assert_close(vals, want, rtol=1e-10, atol=0)


def _reference_inputs():
    cell = sharded_cell(1)
    return cell["config"], cell["traffic"], 2**33 + 23


def _sharded_ritz(mesh):
    from portbench.reference import eigsh_sharded as ref
    from portbench.reference.arith import Arith

    cfg, tr, seed = _reference_inputs()
    group = Group(mesh.rank, mesh.size, mesh.group)
    ar = Arith("f64")
    op, lo, hi = ref.rank_operator(cfg, seed, mesh.device, ar, group)
    b = ref.rank_block(cfg, tr, seed, 0, mesh.device, lo, hi, op.rows_loc)
    vals, _ = ref.ritz(op, b, int(tr["m"]), int(tr["k"]), ar, group, vectors=False)
    return vals


def _whole_ritz():
    from portbench import inputs
    from portbench.reference import eigsh
    from portbench.reference.arith import Arith

    cfg, tr, seed = _reference_inputs()
    ar = Arith("f64")
    op = eigsh._matrix(cfg, seed, "cpu", ar)
    b = inputs.banded_block(op.n, int(tr["p"]), seed, 0, "cpu")
    vals, _ = eigsh.ritz(op, b, int(tr["m"]), int(tr["k"]), ar, vectors=False)
    return vals


FAULTS = "portbench.tests.sharded_faults"


@pytest.mark.parametrize("driver,fault", [("portbench.drivers.eigsh_sharded_control", None),
                                          (FAULTS, "spikes"), (FAULTS, "row"),
                                          (FAULTS, "exchange"), (FAULTS, "stale")],
                         ids=["control", "dropped_halo_row", "dropped_edge_row",
                              "dropped_exchange", "stale_halo"])
def test_is_not_correct(tmp_path, driver, fault):
    out = run_probe(tmp_path, sharded_cell(2, driver=driver, fault=fault))
    res = out["result"]
    assert out["rc"] == 0 and res is not None, out["stderr"][-4000:]
    assert res["failed"] == 0 and not res["correct"] and not out["left"]
    checks = res["checks"]
    # the limits are an order of magnitude below what each reads
    assert any(c["value"] > 4 * c["limit"] for c in checks.values()), checks
    # the product check alone finds every fault of the exchange and the control
    assert checks["apply_rel_err"]["value"] > 10 * checks["apply_rel_err"]["limit"], checks


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_on_four_cards(four_cards, tmp_path, trace):
    out = run_probe(tmp_path, sharded_cell(4, rows=CARD_ROWS), device="cuda", trace=trace,
                    seconds=2.0)
    res = check_sound(out, 4)
    print(f"\nfour cards, trace {trace}: {out['seconds']:.2f} s, ranks {out['ranks']}, "
          f"result {res}")
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    if trace:
        metrics = res["metrics"]
        assert metrics["collectives.eigsh"]["value"] == COLLECTIVES
        assert 0.0 < metrics["exchange_share_pct.eigsh"]["value"] < 100.0
        assert {m["name"] for m in load_cell(CELL)["per_layer"]} <= set(metrics)
