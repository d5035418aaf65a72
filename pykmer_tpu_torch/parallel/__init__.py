"""Multi-device runs of the port: one process driving a grid of devices, and
several such processes in one ``torch.distributed`` job.

- ``mesh``        : the ``[n_data, n_shards]`` device grid
- ``collectives`` : all_to_all, all_gather, ppermute, psum and pmax as
                    explicit copies
- ``histogram``   : the count-space-sharded step of the index path
- ``compare``     : the sharded block step of the merge
- ``encode``      : the halo encoder of a sequence sharded over devices
- ``multihost``   : the process group, input splitting across hosts, the
                    exact saturating cross-host combine, shard checkpoints
"""

from .mesh import DATA_AXIS, SHARD_AXIS, Mesh, make_mesh
from .histogram import (
    flat_to_interleaved,
    interleaved_to_flat,
    make_sharded_accumulate,
    shard_batch_chunks_packed,
)
from .compare import make_sharded_merge_step, make_sharded_pair_matrix
from .encode import make_halo_encode

__all__ = [
    "DATA_AXIS", "SHARD_AXIS", "Mesh", "make_mesh", "flat_to_interleaved",
    "interleaved_to_flat", "make_sharded_accumulate", "shard_batch_chunks_packed",
    "make_sharded_merge_step", "make_sharded_pair_matrix", "make_halo_encode",
]
