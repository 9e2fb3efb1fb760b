"""Device-mesh helpers for multi-device / multi-host inference.

The reference is strictly single-GPU (SURVEY.md §2.8); this layer provides the
scaling axes its intra-GPU decompositions map onto:

- ``data``  axis — rows sharded across devices (the row-parallel kernels'
  cross-device analog); communication-free.
- ``model`` axis — trees sharded across devices (SPLIT_FOREST made
  cross-device); per-tree margins combined with one ``psum`` — the
  distributed rendition of cub::DeviceSegmentedReduce (Struct.h:655-659).
  XLA runs it through NCCL, over NVLink between the cards of one host.

The mesh follows the algorithm only: every card of a host reaches every other
at the same rate, so any (data, model) factorization of ``jax.devices()``
works. Multi-host entry: call :func:`init_distributed` once per process with
an explicit coordinator, then build meshes over ``jax.devices()`` as usual.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper (no-op on a single process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(data: int = 1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``(data, model)`` mesh; either axis may be 1."""
    devices = list(devices if devices is not None else jax.devices())
    need = data * model
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(data, model)
    return Mesh(arr, ("data", "model"))
