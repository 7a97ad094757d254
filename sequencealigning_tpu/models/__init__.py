"""Model families: one aligner class per algorithm.

The reference exposes three algorithms behind free functions dispatched in
main (src/main.rs:63-66); here each is a class with a single-pair API, a
batched device API, and the reference's all-pairs driver semantics
(db x query, per-pair failure isolation)."""

from sequencealigning_tpu.models.base import Aligner, PairResult, get_aligner
from sequencealigning_tpu.models.astar import AStarAligner
from sequencealigning_tpu.models.gotoh import GotohAligner
from sequencealigning_tpu.models.linear import LinearNWAligner
from sequencealigning_tpu.models.wfa import WfaAligner
from sequencealigning_tpu.models.banded import BandedAligner

__all__ = [
    "Aligner",
    "PairResult",
    "get_aligner",
    "AStarAligner",
    "GotohAligner",
    "LinearNWAligner",
    "WfaAligner",
    "BandedAligner",
]
