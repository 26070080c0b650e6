"""The multi-device layer (port of `lanczos_tpu/parallel/`): a 1-D mesh
of ranks on `torch.distributed`, one process per device (`launch.run`),
and the z-slab Maxwell operator, whose every product runs K1 on the
rank's slab after a one-plane halo exchange.  The assembled-matrix
operators of the JAX package (`dist_operator.py`, `dist_windowed.py`)
are not ported yet.
"""

from lanczos_tpu_torch.parallel.dist_stencil import DistributedPallasMaxwell
from lanczos_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "DistributedPallasMaxwell"]
