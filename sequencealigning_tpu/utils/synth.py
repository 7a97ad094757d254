"""Seeded synthetic DNA pairs for benchmarks and the on-card smoke test."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)


def mutated_pairs(
    rng: np.random.Generator, n: int, length: int, divergence: float = 0.01
) -> List[Tuple[bytes, bytes]]:
    """n (query, db) pairs: db is ``length`` random bases; query is db
    with ``divergence * length`` edits, each a substitution (half) or a
    single-base insertion or deletion (a quarter each), cut or padded
    back to ``length``."""
    pairs = []
    n_edits = max(1, int(round(length * divergence)))
    for _ in range(n):
        db = _BASES[rng.integers(0, 4, length)]
        q = bytearray(db.tobytes())
        for kind, pos, base in zip(
            rng.integers(0, 4, n_edits),
            rng.integers(0, length - 1, n_edits),
            rng.integers(1, 4, n_edits),
        ):
            pos = min(int(pos), len(q) - 1)
            if kind == 0:
                del q[pos]
            elif kind == 1:
                q.insert(pos, int(_BASES[base]))
            else:
                q[pos] = int(_BASES[(int(np.flatnonzero(_BASES == q[pos])[0])
                                     + int(base)) % 4])
        q = q[:length]
        while len(q) < length:
            q.append(int(_BASES[rng.integers(0, 4)]))
        pairs.append((bytes(q), db.tobytes()))
    return pairs
