"""The multi-device layer (port of `lanczos_tpu/parallel/`): a 1-D mesh
of ranks on `torch.distributed`, one process per device (`launch.run`);
the z-slab Maxwell operator, whose every product runs K1 on the rank's
slab after a one-plane halo exchange; and the row-sharded assembled-matrix
operators: `HaloShardedWindowed` (a k-hop halo exchange, then K8 on the
rank's windowed-ELL shard), the banded `HaloShardedEll` (the same
exchange, then a local ELL gather) and the general `GatherShardedEll` (an
all-gather of x).  `dryrun` runs one step of the z-slab, halo-ELL and
windowed paths on N ranks.
"""

from lanczos_tpu_torch.parallel.dist_operator import (
    GatherShardedEll,
    HaloShardedEll,
    gather_sharded_ell,
    halo_sharded_ell,
)
from lanczos_tpu_torch.parallel.dist_stencil import DistributedPallasMaxwell
from lanczos_tpu_torch.parallel.dist_windowed import (
    HaloShardedWindowed,
    halo_sharded_windowed,
)
from lanczos_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "DistributedPallasMaxwell", "HaloShardedWindowed",
           "HaloShardedEll", "GatherShardedEll", "halo_sharded_windowed",
           "halo_sharded_ell", "gather_sharded_ell"]
