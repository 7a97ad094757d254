"""Parallel layer: device meshes, the data-parallel batch runner, and the
streaming pipeline.

The reference is single-threaded and single-process (SURVEY.md §2: no
threads/rayon/MPI anywhere; the pair loop src/main.rs:61-78 is sequential),
so this layer is net-new design: pairs are sharded over a
jax.sharding.Mesh data axis with shard_map, results merged with XLA
collectives over the interconnect, multi-host runs initialized via
jax.distributed.initialize."""

from sequencealigning_tpu.parallel.mesh import make_mesh, multihost_init
from sequencealigning_tpu.parallel.runner import DataParallelRunner
from sequencealigning_tpu.parallel.seqpar import seqpar_align, seqpar_fill
from sequencealigning_tpu.parallel.streaming import stream_align

__all__ = [
    "make_mesh", "multihost_init", "DataParallelRunner",
    "stream_align", "seqpar_fill", "seqpar_align",
]
