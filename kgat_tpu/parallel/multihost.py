"""Multi-host (DCN) execution (SURVEY.md §M5).

On a multi-host cluster, each host runs this same program;
`jax.distributed.initialize` forms the process group and `jax.devices()`
then spans every host, so the edge-partitioned mesh
(kgat_tpu.parallel.halo) extends across hosts unchanged — the 'ep' axis
simply covers more devices, with XLA routing intra-host collectives over
the host's links and cross-host legs over the network.

Host-side data handling: every host loads the dataset and partitions the
CKG identically (deterministic), then `stack_shards` device_puts only its
OWN devices' shard slices and assembles the global stacked Graph with
`jax.make_array_from_single_device_arrays` — no cross-host transfer, and
each shard lands directly on its owning device (also used on one host:
the stacked graph is born sharded instead of being resharded per step).

Two-host launch (the coordinator address, process count and process id
come from these env vars; nothing infers them):

    host0$ COORDINATOR_ADDRESS=host0:8476 NUM_PROCESSES=2 PROCESS_ID=0 \\
           python -m kgat_tpu.train --preset yelp-partitioned
    host1$ COORDINATOR_ADDRESS=host0:8476 NUM_PROCESSES=2 PROCESS_ID=1 \\
           python -m kgat_tpu.train --preset yelp-partitioned

The trainer calls `initialize_distributed()` (a no-op single-process) and
builds the mesh over `jax.devices()` — every host's devices.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec


_initialized: "Optional[tuple]" = None  # (coordinator, n_procs, proc_id)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Form the multi-host process group; returns this process's id.

    No-ops on a single process. Args
    default to the standard env vars (COORDINATOR_ADDRESS, NUM_PROCESSES,
    PROCESS_ID), which the launcher sets.
    """
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 1))
    if num_processes <= 1 or not coordinator:
        return 0
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PROCESS_ID", 0)))
    # Idempotence without touching the backend: jax.process_count() would
    # itself initialize local-only devices, which is exactly the failure
    # this function must precede. A module flag keeps re-entry safe — but
    # a re-entrant call with a DIFFERENT group spec is a misconfiguration
    # (e.g. a harness passing a new port after env-driven init already
    # ran), not idempotence, so it raises (ADVICE r3).
    global _initialized
    spec = (coordinator, num_processes, process_id)
    if _initialized is not None:
        if _initialized != spec:
            raise RuntimeError(
                "initialize_distributed called twice with conflicting "
                f"group specs: first {_initialized}, now {spec}")
        return jax.process_index()
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = spec
    return process_id


def local_shard_ids(n_parts: int) -> list[int]:
    """Which partition ids this host's local devices own (mesh order)."""
    n_local = jax.local_device_count()
    start = jax.process_index() * n_local
    return [p for p in range(start, min(start + n_local, n_parts))]


def stack_shards(shard_arrays, mesh, axis: str = "ep"):
    """Stack per-shard arrays along a new leading mesh axis, placing each
    shard directly on its owning device(s).

    shard_arrays: sequence covering ALL n_parts shards (host-side or
    device arrays). Only this process's addressable shards are
    materialized; the rest are addressed by other processes. Works on any
    mesh: with extra axes (e.g. a 2D (dp, ep) mesh) each shard is placed
    on every device of its `axis` coordinate (replicated across the other
    axes). Returns a global (n_parts, ...) jax.Array sharded P(axis).
    """
    arrs = [np.asarray(a) for a in shard_arrays]
    sharding = NamedSharding(mesh, PartitionSpec(axis))
    global_shape = (len(arrs),) + arrs[0].shape

    def cb(index):
        s = index[0]
        lo, hi, _ = s.indices(len(arrs))
        return np.stack(arrs[lo:hi])

    return jax.make_array_from_callback(global_shape, sharding, cb)


def stack_pytrees(per_shard_trees, mesh, axis: str = "ep"):
    """Leaf-wise :func:`stack_shards` over per-shard pytrees (e.g. the
    per-shard Graphs of an edge partition)."""
    return jax.tree.map(
        lambda *xs: stack_shards(xs, mesh, axis), *per_shard_trees)
