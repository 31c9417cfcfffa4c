"""Device-mesh utilities for multi-device / multi-host execution.

The reference has no distributed execution of any kind (SURVEY §2c — its
only concurrency is a thread pool over decoders). Here the scaling story
is the JAX SPMD recipe: pick a ``Mesh``, annotate shardings, let XLA
insert the collectives (NCCL; the cards of one host are joined all to all
by NVLink, so the mesh is a flat 1-D batch axis, never a torus shape).

The framework's natural parallel axis is the codeword batch ("data
parallel" in the domain: frames are independent); weight tables and
quantizer LUTs are tiny and replicated. Error statistics cross devices as
four ``psum``'d scalars per wave.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "batch_sharding", "replicated", "distributed_init"]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the batch axis (the framework's only sharded axis).

    Uses all visible devices by default — across several hosts call
    :func:`distributed_init` first so ``jax.devices()`` spans them.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} visible")
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> NamedSharding:
    """Shard the leading (batch) dimension across the mesh."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (weight tables, LUTs, scalars)."""
    return NamedSharding(mesh, PartitionSpec())


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (one call per host before device use).

    Thin wrapper over ``jax.distributed.initialize`` that no-ops when
    running single-process (the common case: one process drives every
    card of a host). Several processes need ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` given here:
    nothing in the environment describes the cluster.
    """
    if num_processes in (None, 1) and coordinator_address is None and \
            "COORDINATOR_ADDRESS" not in os.environ:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
