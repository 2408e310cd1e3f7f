"""Device mesh construction.

The replacement for the reference's MPI rank topology (flat COMM_WORLD
with rank 0 as coordinator, SURVEY.md §2.3): a jax.sharding.Mesh with named
axes
  "q" — auxiliary-basis (Q) shards for the DF B tensor: the direct analog of
        the reference's aux partition across ranks x GPUs
        (DynamicLoad.jl:160-203, GPUDF.jl:1026-1056);
  "k" — secondary axis sharding exchange-matrix columns (tensor-parallel-like)
        used when a single q-shard row has multiple devices.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(n_devices: int | None = None, k_axis: int = 1) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % k_axis != 0:
        raise ValueError(f"n_devices={n} not divisible by k_axis={k_axis}")
    arr = np.array(devs[:n]).reshape(n // k_axis, k_axis)
    return Mesh(arr, ("q", "k"))


def initialize_distributed() -> bool:
    """Multi-host runtime bring-up (hosts joined by a network) — the analog
    of the reference's MPI.Init() across nodes (JCRuntime.jl:6-16).

    Calls jax.distributed.initialize() when a cluster environment is
    detected (Slurm and Open MPI via ``jax.distributed``'s cluster plugins;
    explicit coordination uses the JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID variables).  Single-process runs
    are a no-op.  Idempotent.
    Returns True if a multi-process runtime is (now) active.
    """
    import os

    # NOTE: do not touch jax.process_count()/jax.devices() before
    # jax.distributed.initialize() — any backend query initializes XLA and
    # makes distributed bring-up impossible in this process.
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    env = os.environ
    explicit = env.get("JAX_COORDINATOR_ADDRESS") or env.get(
        "COORDINATOR_ADDRESS")

    def _multi(var):
        try:
            return int(env.get(var, "1")) > 1
        except ValueError:
            return False

    # only auto-initialize when the detected cluster provably has >1
    # process — a single-process shell inside a multi-task SLURM allocation
    # (or with stale MPI variables) must NOT block waiting for peers.
    # JCHEM_DISTRIBUTED=1 forces the attempt regardless.
    cluster = _multi("SLURM_NTASKS") or _multi("OMPI_COMM_WORLD_SIZE")
    forced = env.get("JCHEM_DISTRIBUTED") == "1"
    if not explicit and not cluster and not forced:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=explicit or None,
            num_processes=(int(env["JAX_NUM_PROCESSES"])
                           if "JAX_NUM_PROCESSES" in env else None),
            process_id=(int(env["JAX_PROCESS_ID"])
                        if "JAX_PROCESS_ID" in env else None),
        )
    except RuntimeError as exc:
        # idempotent path: only the already-initialized error is benign;
        # genuine bring-up failures must surface, not silently degrade to
        # single-process
        if "already initialized" not in str(exc).lower():
            raise
    return jax.process_count() > 1


def make_global_mesh(k_axis: int | None = None) -> Mesh:
    """Global mesh over every device of every host, laid out so that the
    "q" (auxiliary-row) axis spans hosts and the "k" axis stays inside a
    host.

    Rationale: the per-iteration collectives on "k" (all_gather of W / G
    columns, parallel/shard.py) move O(nbf^2) data every Fock build and
    belong on the links inside a host; the "q" axis only psums the final
    [nbf, ncol] partials once per iteration, so it tolerates the network
    between hosts.  The reference handles the same split with MPI ranks
    spanning nodes (GPUDF.jl's rank x device virtual-rank grid,
    :1011-1055).
    """
    initialize_distributed()
    n_local = jax.local_device_count()
    n_hosts = jax.process_count()
    if k_axis is None:
        k_axis = n_local if n_hosts > 1 else 1
    n = n_local * n_hosts
    if n % k_axis != 0:
        raise ValueError(f"{n} devices not divisible by k_axis={k_axis}")
    if n_hosts == 1:
        return make_mesh(n, k_axis=k_axis)
    from jax.experimental import mesh_utils

    if k_axis % n_local == 0 and k_axis >= n_local:
        between = (n // k_axis, k_axis // n_local)
        within = (1, n_local)
    else:
        # k within host, q split across hosts (and within host if q > hosts)
        if n_local % k_axis != 0:
            raise ValueError(
                f"k_axis={k_axis} must divide local device count {n_local} "
                f"(or be a multiple of it)")
        between = (n_hosts, 1)
        within = (n_local // k_axis, k_axis)
    try:
        arr = mesh_utils.create_hybrid_device_mesh(
            within, between, devices=jax.devices())
    except ValueError:
        # backends without slice metadata (CPU multi-process): build the
        # same host-major layout explicitly — q spans hosts, k contiguous
        # within a host
        devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
        arr = np.array(devs).reshape(n // k_axis, k_axis)
    return Mesh(arr, ("q", "k"))


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    """Zero-pad one axis up to a multiple (even Q-shards: the analog of the
    reference's uneven Allgatherv + reorder, which SPMD avoids by padding)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad)
