"""Host rescoring of a gapped alignment under an affine scheme."""

from __future__ import annotations

from sequencealigning_tpu.config import ScoringScheme


def affine_rescore(
    a1: str, a2: str, scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
) -> int:
    """Score of the aligned strings a1/a2 ('-' = gap) under the Gotoh
    model: a gap run costs gap_open + len * gap_extend.  compat adds the
    reference's extra extension on a leading gap run
    (needleman_wunsch_affine.rs:195,207)."""
    s = 0
    in_gap = None
    for c1, c2 in zip(a1, a2):
        if c1 == "-" or c2 == "-":
            g = "1" if c1 == "-" else "2"
            s += scheme.gap_extend + (scheme.gap_open if in_gap != g else 0)
            in_gap = g
        else:
            s += scheme.match_ if c1 == c2 else scheme.mismatch
            in_gap = None
    if compat and a1 and (a1[0] == "-" or a2[0] == "-"):
        s += scheme.gap_extend
    return s
