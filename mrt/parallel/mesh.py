"""Device mesh construction + distributed runtime init.

The reference's only parallelism is `std::thread` row-stealing on one CPU
(reference: src/main.rs:159-212).  The equivalent here is a 2D logical
mesh over all devices:

  axis "tile": image rows are statically sharded     (replaces dynamic
               row stealing — SPMD work is uniform, so static tiles win)
  axis "spp":  samples are strided across devices    (replaces the
               per-thread whole-frame passes, main.rs:234-294)

Within a slice the collectives (one psum of the accumulated (sum, count)
image per pass, main.rs:629-638's mutex merge) ride ICI.  Multi-host runs
initialise `jax.distributed` and use the same mesh spanning all processes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

TILE_AXIS = "tile"
SPP_AXIS = "spp"


def make_mesh(tile=None, spp=1, devices=None):
    """Build a (tile, spp) mesh over the available devices.

    Defaults to all devices on the tile axis (maximum image-space
    parallelism, the right call for large frames).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if tile is None:
        tile = n // spp
    if tile * spp != n:
        raise ValueError(f"mesh {tile}x{spp} != {n} devices")
    arr = np.asarray(devices).reshape(tile, spp)
    return Mesh(arr, (TILE_AXIS, SPP_AXIS))


def render_mesh(n_devices=None):
    """Convenience: all-tile mesh (spp axis size 1)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return make_mesh(devices=devices)


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Initialise the multi-host runtime (no-op on a single process).

    The reference has no distributed backend at all (SURVEY §2); this is
    the equivalent: device-to-device links within a host, the network
    across hosts, all hidden behind `jax.distributed`.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
