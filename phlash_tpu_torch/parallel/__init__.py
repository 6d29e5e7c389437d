"""Multi-GPU fitting over torch.distributed: a (p, d) device mesh.

Port of phlash_tpu/parallel: `fit(mesh=make_mesh())` shards the SVGD
particle cloud over the mesh's "p" axis and the chunk tensor over its "d"
axis, one process per device (`torchrun --nproc-per-node N script.py`),
with NCCL collectives inside the CUDA graphs of the fit's calls.  See
parallel/mesh.py for what crosses devices.
"""

from phlash_tpu_torch.parallel.mesh import (
    chunk_sharding,
    make_mesh,
    particle_sharding,
    replicated,
    shard_training_step,
)

__all__ = [
    "make_mesh",
    "particle_sharding",
    "chunk_sharding",
    "replicated",
    "shard_training_step",
]
