"""Multi-host scaling scaffolding — BASELINE.json config 5 (4096
scenarios across N≥2 hosts): `jax.distributed.initialize` launch, a
(hosts × local devices) mesh, and scenario sharding over both axes.

The reference's "distributed" layer is ROS 2 DDS pub/sub between
processes on one machine (`rtps_udp_profile.xml`); it has no multi-node
compute. Here scenarios are pure data-parallel, so the mesh is
(hosts: n_hosts, devices: devices_per_host) with the scenario batch
sharded over BOTH axes flattened; cost reductions `psum` over the local
devices first and across hosts second, so only one small reduction
crosses between hosts.

Single-process virtual-device testing: `make_host_mesh(n_hosts=2,
devices_per_host=4)` reshapes 8 forced CPU devices into the same mesh,
so the multi-host program compiles and runs without a cluster
(`--xla_force_host_platform_device_count` fakes).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HOST_AXIS = "hosts"       # across hosts
DEVICE_AXIS = "devices"   # across the devices of one host


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """`jax.distributed.initialize` wrapper: no-op in single-process runs
    (returns False), env-driven otherwise. Safe to call unconditionally
    at program start — the multi-host analogue of the reference's DDS
    discovery, which also needs no config on one machine.

    Env fallbacks: DDDMR_COORDINATOR, DDDMR_NUM_PROCESSES,
    DDDMR_PROCESS_ID (plus whatever cluster-autodetect jax supports).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "DDDMR_COORDINATOR")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("DDDMR_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("DDDMR_PROCESS_ID", "0"))
    if coordinator_address is None or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return True


def make_host_mesh(n_hosts: int | None = None,
                   devices_per_host: int | None = None) -> Mesh:
    """(hosts, devices) mesh over all visible devices.

    In a real multi-process run, `jax.devices()` is globally ordered with
    each process's local devices contiguous, so reshaping to
    (n_hosts, devices_per_host) puts each host's devices on one row. In
    single-process testing the same reshape fakes N hosts over virtual
    devices.
    """
    devs = np.asarray(jax.devices())
    if n_hosts is None:
        n_hosts = jax.process_count()
    if devices_per_host is None:
        devices_per_host = len(devs) // n_hosts
    devs = devs[: n_hosts * devices_per_host]
    return Mesh(devs.reshape(n_hosts, devices_per_host),
                axis_names=(HOST_AXIS, DEVICE_AXIS))


def scenario_sharding(mesh: Mesh) -> NamedSharding:
    """Scenario batch axis sharded over hosts × devices flattened."""
    return NamedSharding(mesh, P((HOST_AXIS, DEVICE_AXIS)))


def sharded_fleet_tick_multihost(cfg, mesh: Mesh):
    """Jitted fleet control tick over the (hosts, devices) mesh:
    per-robot commands stay sharded; the fleet-health scalar is a
    hierarchical psum (within each host, then across hosts).
    """
    from jax import shard_map
    from dddmr_navigation_tpu.parallel.fleet import fleet_tick

    def tick(plans, state, obstacles, obs_valid):
        vx, wz, codes, costs = fleet_tick(cfg, plans, state, obstacles,
                                          obs_valid)
        ok = costs >= 0
        local = jnp.stack([jnp.sum(jnp.where(ok, costs, 0.0)),
                           jnp.sum(ok.astype(jnp.float32))])
        local = jax.lax.psum(local, DEVICE_AXIS)   # within each host
        local = jax.lax.psum(local, HOST_AXIS)     # across hosts
        return vx, wz, codes, costs, local[0] / jnp.maximum(local[1], 1.0)

    spec = P((HOST_AXIS, DEVICE_AXIS))
    sharded = shard_map(
        tick, mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec, spec, spec, P()),
        check_vma=False)
    return jax.jit(sharded)


def host_local_batch(mesh: Mesh, tree):
    """Assemble a globally-sharded scenario batch from per-process local
    arrays (`jax.make_array_from_process_local_data`): each host feeds
    only its own robots' sensors/plans — no robot data crosses hosts.
    Falls back to plain device_put placement in single-process runs.
    """
    sharding = scenario_sharding(mesh)
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sharding), tree)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(sharding, x), tree)
