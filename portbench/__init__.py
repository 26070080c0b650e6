"""portbench: the benchmark of `lanczos_tpu_torch` on one NVIDIA H100.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once (README.md).  Everything a cell needs is
found by name: its configuration in `configs/`, its traffic in `traffic/`,
its limits in `limits/`, the driver the traffic names in `drivers/`, that
driver's plain reference in `reference/` and its least-traffic count in
`counts/`, and each metric in `metrics/`.  Nothing here imports JAX or
the JAX package; only `drivers/` imports the port.
"""
