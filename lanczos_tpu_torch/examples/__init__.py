"""Examples of the port (port of the repository's `examples/`), each
runnable as `python -m lanczos_tpu_torch.examples.<name>`: on the card by
default, `--device cpu` on the CPU.

    eigsh_laplacian          top-k eigenvalues of a 2-D Laplacian, f64
    expm_maxwell             expm(A) B at a receiver row, FDTD oracle check
    fused_and_compensated    the fused recurrence and the compensated Gram
    windowed_general_matrix  SpMM and eigsh of an assembled matrix (K8)
    inplace_fast_paths       the mono step and K5 into a second buffer
    distributed_lanczos      block eigsh on the z-slab operator, N ranks
"""
