"""Device-mesh construction and multi-host initialization."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """Build a Mesh over the available devices.

    Default: all devices on one 'data' axis (the throughput axis for
    pairwise alignment -- each chip fills an independent slab of pairs; the
    only collective is the result merge).  Multi-axis shapes are accepted
    for future sequence-parallel sharding of a single huge pair.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None or not shape:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names[: len(shape)]))


def multihost_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize wrapper for multi-host slices.

    Pass the coordinator address, process count and process id; on a
    managed cluster they may auto-detect.  Safe to call when already initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise
