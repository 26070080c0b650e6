"""The drivers: one module a traffic's `driver` names, each a `Driver`
class whose constructor is the cell's set-up (the port's operator, the
inputs from the seed, the pool of start blocks) and whose `request()` is
one user call to the port, waited for on the host.  Only these modules
import the port."""


def load_kernels(device, phases) -> None:
    """Load the port's CUDA kernel library (nvcc builds it, into the
    checkout's `lanczos_tpu_torch/_build/`, on the first run there); on
    the CPU every kernel wrapper runs its plain version."""
    if device.type == "cuda":
        from lanczos_tpu_torch.ops.kernels import build

        with phases("kernels"):
            build.library()


def maxwell_setup(cfg, p: int, pool: int, seed: int, device, phases):
    """The configuration's folded-plane Maxwell operator and the pool of
    start blocks packed into its layout: (6, Zc, P) each for p = 1, else
    (p, 6, Zc, P)."""
    import torch

    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from portbench import inputs

    n = int(cfg["n_grid"])
    with phases("operator"):
        op = PallasMaxwellOperator.create(n, n, n, dtype=getattr(torch, cfg["dtype"]),
                                          device=device)
    with phases("inputs"):
        blocks = [op.pack(inputs.maxwell_block(cfg, p, seed, k, device)) for k in range(pool)]
    return op, [b[0] if p == 1 else b for b in blocks]
