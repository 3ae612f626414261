"""Multi-device scaling-efficiency harness.

Renders the RTIOW final scene tile-sharded over 1..N devices and
reports throughput + parallel efficiency.  On a multi-GPU host this
measures real scaling; under `--xla_force_host_platform_device_count=N`
it validates the sharding logic (CPU times are not meaningful).

    python bench_scaling.py [width height spp depth]
"""

from __future__ import annotations

import json
import sys
import time


def main():
    import jax

    from mrt.scenes import get
    from mrt.parallel.mesh import make_mesh
    from mrt.parallel.render import render_sharded

    width = int(sys.argv[1]) if len(sys.argv) > 1 else 1920
    height = int(sys.argv[2]) if len(sys.argv) > 2 else 1080
    spp = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    depth = int(sys.argv[4]) if len(sys.argv) > 4 else 50

    n_dev = len(jax.devices())
    platform = jax.devices()[0].platform
    host_mesh = platform == "cpu"
    scene, camera = get("rtiow")(aspect_ratio=width / height).generate()

    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    results = {}
    base = None
    for n in sizes:
        if height % n:
            continue
        mesh = make_mesh(devices=jax.devices()[:n])
        # Warmup/compile.
        film = render_sharded(scene, camera, width, height, mesh, spp=1,
                              max_depth=depth, persistent=True)
        film.sum.block_until_ready()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            film = render_sharded(scene, camera, width, height, mesh,
                                  spp=spp, max_depth=depth,
                                  persistent=True, film=None)
            film.sum.block_until_ready()
            best = min(best, time.perf_counter() - t0)
        rays = width * height * spp / best
        if base is None:
            base = rays
        # On real devices, efficiency = rays/(base*n).  On a virtual
        # CPU host mesh all N "devices" share
        # one socket, so ideal is FLAT throughput and the meaningful
        # number is retention = rays/base (sharding overhead only).
        eff = rays / (base * n)
        ret = rays / base
        results[n] = {"rays_per_sec": round(rays, 1),
                      "efficiency": round(eff, 4),
                      "retention": round(ret, 4)}
        print(f"# {n} device(s): {rays / 1e6:.3f}M rays/s, "
              f"{'retention' if host_mesh else 'efficiency'} "
              f"{(ret if host_mesh else eff):.2%}", file=sys.stderr)

    print(json.dumps({
        "metric": "scaling_efficiency",
        "platform": platform,
        "host_mesh": host_mesh,
        "workload": {"width": width, "height": height, "spp": spp,
                     "depth": depth},
        "note": ("virtual host mesh: N devices share one socket; "
                 "ideal is flat throughput (retention ~1)"
                 if host_mesh else
                 "real accelerator mesh: efficiency = rays/(base*N)"),
        "devices": results}))


if __name__ == "__main__":
    main()
