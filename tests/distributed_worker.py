"""Worker for the multi-process distributed test (run by
tests/test_distributed.py, one subprocess per simulated host).

Initialises `jax.distributed` over CPU processes (4 virtual devices
each), renders over the process-spanning (tile, spp) mesh, gathers the
film, and compares bit-exactly against an unsharded single-device
render of the same scene — SURVEY §7 step 6's multi-host contract.
"""

import os
import sys

pid = int(sys.argv[1])
nprocs = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["MRT_NO_COMPILE_CACHE"] = "1"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from mrt.parallel.mesh import init_distributed, make_mesh  # noqa: E402

init_distributed(coordinator=f"localhost:{port}", num_processes=nprocs,
                 process_id=pid)
assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

from mrt.core.camera import Camera  # noqa: E402
from mrt.geometry.scene import SceneBuilder  # noqa: E402
from mrt.materials.table import MaterialBuilder  # noqa: E402
from mrt.materials.background import SkyBackground  # noqa: E402
from mrt.parallel.render import render_sharded  # noqa: E402
from mrt.runtime.render import render  # noqa: E402

mat = MaterialBuilder()
ground = mat.lambertian((0.5, 0.5, 0.5))
metal = mat.metal(0.2, (0.8, 0.7, 0.6))
glass = mat.dielectric(1.5)
sb = SceneBuilder(mat, SkyBackground.create())
sb.add_sphere((0, -100.5, -1), 100.0, ground)
sb.add_sphere((0, 0, -1), 0.5, metal)
sb.add_sphere((-1.1, 0, -1), 0.5, glass)
scene = sb.build()
camera = Camera.create(60.0, (0, 0.5, 2), (0, 0, -1), (0, 1, 0), 1.0,
                       focus_distance=3.0)

W = H = 32
mesh = make_mesh(tile=2 * nprocs, spp=2)   # spans both processes
film = render_sharded(scene, camera, W, H, mesh, spp=4, seed=3,
                      max_depth=6, samples_per_pass=2)

from jax.experimental import multihost_utils  # noqa: E402

# Collectives: EVERY process must participate (hoisted out of the
# pid-0 block — a collective under `if pid == 0` deadlocks the other
# process into the shutdown barrier).
gathered = multihost_utils.process_allgather(film.sum, tiled=True)
gathered_depth = multihost_utils.process_allgather(film.depth_sum,
                                                   tiled=True)

single = render(scene, camera, W, H, spp=4, seed=3, max_depth=6,
                samples_per_pass=2)

if pid == 0:
    # Same estimator, same draws; only float accumulation order differs
    # (the spp-axis psum vs sequential adds), as in tests/test_parallel.
    np.testing.assert_allclose(np.asarray(gathered),
                               np.asarray(single.sum),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(gathered_depth),
                                  np.asarray(single.depth_sum))
    print("DISTRIBUTED_OK", flush=True)
jax.distributed.shutdown()
