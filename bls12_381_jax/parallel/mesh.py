"""Mesh construction helpers.

One 1-D data axis is all these workloads need: MSM partitions points,
NTT partitions matrix rows.  The mesh follows the algorithm alone: the
cards of one host reach each other all to all (NVLink), and XLA lowers
the collectives to NCCL.  Several processes extend the same mesh via
:func:`init_distributed` (call it once per process before any other JAX
use — see tests/dist_worker.py for the complete 2-process recipe).
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("bls12_381_jax.parallel")

SHARD_AXIS = "shards"

_DISTRIBUTED_INITIALIZED = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     **kw) -> bool:
    """Join a multi-process run; returns True if distributed is active.

    The multi-process analog of the reference's (absent) multi-GPU
    support: after this, ``jax.devices()`` spans every process's devices
    and ``default_mesh()`` builds a global mesh over them.  Call once per
    process before any other JAX use.

    Arguments default to the standard env vars
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``,
    or the cluster's automatic discovery where JAX supports one, opted
    into with ``MIDNIGHT_DISTRIBUTED=1``).  Safe to call when single-process:
    with no coordinator configured it logs and returns False instead of
    hanging, so library code can call it unconditionally.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    # Cluster auto-discovery (no coordinator arg) needs an explicit opt-in:
    # a wrong guess here hangs the process waiting for peers.
    pod_auto = os.environ.get("MIDNIGHT_DISTRIBUTED", "0") not in ("0", "")
    if coordinator_address is None and not pod_auto:
        logger.info(
            "init_distributed: no coordinator configured; staying single-process")
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )
    _DISTRIBUTED_INITIALIZED = True
    logger.info(
        "init_distributed: process %d/%d, %d global devices",
        jax.process_index(), jax.process_count(), len(jax.devices()))
    return True


def shard_axis() -> str:
    return SHARD_AXIS


def default_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (SHARD_AXIS,))


def data_sharding(mesh: Mesh, axis_index: int, ndim: int) -> NamedSharding:
    """NamedSharding that splits array axis ``axis_index`` across the mesh."""
    spec = [None] * ndim
    spec[axis_index] = SHARD_AXIS
    return NamedSharding(mesh, P(*spec))
