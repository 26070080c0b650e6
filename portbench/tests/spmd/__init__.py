"""A test-only SPMD probe of the harness's multi-rank path: no cell of
BENCHMARK.json names it; `test_portbench_ranks.py` builds its cell.  Its
operator is a seeded band of `2 halo + 1` diagonals over `rows` rows a
rank, row-partitioned over the ranks, so that a product needs `halo` rows
of each neighbour's block (`inputs.py`).  The driver (`driver.py`) takes
them through the port's `Mesh`; the reference (`reference.py`) in float64
through plain `torch.distributed`; `counts.py` is one rank's least
traffic; `control.py` is its control, the reference in bfloat16 run as
the program."""
