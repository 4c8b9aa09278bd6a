"""Device mesh construction + multi-host init (SURVEY.md §2.2 #20, #24).

The reference's device runtime is OpenCL platform/context discovery
(SURVEY.md §3.2); the JAX equivalent is jax.distributed for the
multi-host rendezvous plus a 1-D named mesh (the algorithm's shape; every
GPU of a host reaches every other over NVLink) over which pjit/shard_map
place collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host rendezvous (no-op single-host). Mirrors the call stack
    in SURVEY.md §3.2: jax.distributed.initialize → jax.devices()."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def data_mesh(axis: str = "data", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or given) devices for batch data parallelism."""
    devs = list(devices) if devices is not None else jax.devices()
    return jax.make_mesh((len(devs),), (axis,), devices=devs)


def rows_mesh(axis: str = "rows", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh for MCU-row sharding of a single giant image."""
    devs = list(devices) if devices is not None else jax.devices()
    return jax.make_mesh((len(devs),), (axis,), devices=devs)


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))
