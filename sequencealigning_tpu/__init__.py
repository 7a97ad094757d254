"""sequencealigning_tpu: a batched pairwise sequence-alignment framework.

A ground-up JAX re-design of the capabilities of the reference Rust CLI
(Qw11111111111/SequenceAligning): weighted-A* search, affine-gap
Needleman-Wunsch (Gotoh), linear-gap NW, and wavefront alignment (WFA) with
adaptive pruning -- plus what the reference lacks: batched anti-diagonal
fills (CUDA kernels on an NVIDIA GPU, lax.scan on the CPU), data-parallel
scaling over device meshes via jax.sharding/shard_map, structured results,
and benchmarks.
"""

from sequencealigning_tpu.config import (
    AlignConfig,
    Algo,
    Mode,
    ScoringScheme,
    WfaPenalties,
    WfaPruning,
)
from sequencealigning_tpu.errors import (
    AlignerError,
    AlignmentError,
    CharError,
    FastaError,
)
from sequencealigning_tpu.io import (
    PairBatch,
    Record,
    Records,
    pack_arrays,
    pack_batch,
    parse_fasta,
)

__version__ = "0.4.0"

__all__ = [
    "AlignConfig",
    "Algo",
    "Mode",
    "ScoringScheme",
    "WfaPenalties",
    "WfaPruning",
    "AlignerError",
    "AlignmentError",
    "CharError",
    "FastaError",
    "PairBatch",
    "Record",
    "Records",
    "pack_arrays",
    "pack_batch",
    "parse_fasta",
    "__version__",
]
