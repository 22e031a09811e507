"""Device mesh construction and multi-host initialization."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

RAYS_AXIS = "rays"      # data parallel over pixels/rays
SAMPLES_AXIS = "samples"  # sample parallel over spp


def device_mesh(n_rays_shards: Optional[int] = None,
                n_sample_shards: int = 1,
                devices: Optional[Sequence] = None) -> jax.sharding.Mesh:
    """Build a (rays, samples) mesh over the available devices.

    Default: all devices on the rays axis — the device analog of the
    reference's (W/8)x(H/8) workgroup grid, but across chips.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_rays_shards is None:
        n_rays_shards = len(devices) // n_sample_shards
    use = n_rays_shards * n_sample_shards
    arr = np.asarray(devices[:use]).reshape(n_rays_shards, n_sample_shards)
    return jax.sharding.Mesh(arr, (RAYS_AXIS, SAMPLES_AXIS))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` with explicit or
    env-provided topology.  After this, ``jax.devices()`` spans all hosts
    and meshes built from it shard across DCN/ICI automatically.  No-op if
    already initialized or single-process."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # Already initialized or single-process run.
        pass


def _bounds_from_slices(slices, n: int) -> tuple:
    """Hull of a process's index slices; raises on non-contiguous
    ownership (an exotic device order this driver does not support)."""
    if not slices:
        return 0, 0
    starts = [s.start or 0 for s in slices]
    stops = [n if s.stop is None else s.stop for s in slices]
    lo, hi = min(starts), max(stops)
    if sum(b - a for a, b in zip(starts, stops)) != hi - lo:
        raise ValueError(
            "process owns a non-contiguous slice of the rays axis; "
            "reorder the mesh devices process-major (parallel/mesh.py)"
        )
    return lo, hi


def local_shard_bounds(n: int, mesh: jax.sharding.Mesh,
                       process_index: Optional[int] = None) -> tuple:
    """Row range of ``n`` items owned by this process under rays-sharding —
    used by multi-host drivers to generate only their tile of the image.

    Derived from the sharding's actual device->index map (NOT from an
    assumed process-major device order): correct for any mesh whose
    per-process ownership is contiguous, and loud otherwise."""
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(RAYS_AXIS))
    pid = jax.process_index() if process_index is None else process_index
    imap = sharding.devices_indices_map((n,))
    slices = [idx[0] for dev, idx in imap.items()
              if dev.process_index == pid]
    return _bounds_from_slices(slices, n)
