"""Benchmark: RTIOW final scene throughput on the GPU.

Workload per BASELINE.md: the RTIOW final scene at 1920x1080 with the
reference's MAX_DEPTH=50 (reference: src/main.rs:37-41), persistent
integrator.  Each spp bucket compiles its own program, so each gets its
own untimed warm-up pass; the headline is the median of 3 steady passes
at spp=64, with the spp=8 steady numbers on stderr.

Fails unless JAX's device is a GPU.  Prints the card's name and power
limit on stderr and ONE JSON line on stdout:
{"metric", "value", "unit", "device"}.

Run: `python bench.py`.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

WIDTH, HEIGHT = 1920, 1080
SPP = 8
SPP_BASELINE = 64
MAX_DEPTH = 50


def main():
    from mrt.utils.device import card_name_and_power_limit, require_gpu

    platform, kind, count = require_gpu()
    print(f"# card: {card_name_and_power_limit()}", file=sys.stderr)

    from mrt.scenes import get
    from mrt.runtime.render import render_pass_persistent
    from mrt.runtime.film import Film

    scene, camera = get("rtiow")(aspect_ratio=WIDTH / HEIGHT).generate()

    def one_pass(film, start, spp):
        film = render_pass_persistent(scene, camera, film, 1, start,
                                      width=WIDTH, height=HEIGHT,
                                      max_depth=MAX_DEPTH, samples=spp)
        film.sum.block_until_ready()
        return film

    film = Film.create(WIDTH, HEIGHT)
    # Warm-up: compile + adaptive chunk ramp with the SAME statics as
    # the timed passes (the pool is bucketed by spp, so a 1-spp warmup
    # would compile a different program and leave the timed one cold).
    t0 = time.perf_counter()
    film = one_pass(film, 0, SPP)
    warm_s = time.perf_counter() - t0
    depth_before = int(film.depth_sum.sum())

    runs = []
    start = SPP
    for _ in range(3):
        t0 = time.perf_counter()
        film = one_pass(film, start, SPP)
        runs.append(time.perf_counter() - t0)
        start += SPP

    camera_rays = WIDTH * HEIGHT * SPP
    dt = statistics.median(runs)
    rays_per_sec = camera_rays / dt
    segments = ((int(film.depth_sum.sum()) - depth_before) // 3
                + camera_rays)

    # The spp=64 program is DIFFERENT from the spp=8 one (the pool is
    # bucketed by spp), so warm it separately.
    t0 = time.perf_counter()
    film = one_pass(film, start, SPP_BASELINE)
    warm64_s = time.perf_counter() - t0
    start += SPP_BASELINE
    runs64 = []
    for _ in range(3):
        t0 = time.perf_counter()
        film = one_pass(film, start, SPP_BASELINE)
        runs64.append(time.perf_counter() - t0)
        start += SPP_BASELINE
    dt64 = statistics.median(runs64)
    rays64 = WIDTH * HEIGHT * SPP_BASELINE / dt64

    print(f"# warm-up (compile+ramp) {warm_s:.2f}s; steady spp={SPP} "
          f"runs {['%.3f' % r for r in runs]}s -> median {dt:.3f}s = "
          f"{rays_per_sec/1e6:.2f}M camera rays/s, "
          f"{segments/dt/1e6:.2f}M path segments/s; "
          f"spp={SPP_BASELINE} warm {warm64_s:.1f}s, "
          f"runs {['%.2f' % r for r in runs64]}s -> median {dt64:.2f}s "
          f"= {rays64/1e6:.2f}M rays/s", file=sys.stderr)

    print(json.dumps({
        "metric": "camera_rays_per_sec_rtiow1080p_spp64_d50",
        "value": round(rays64, 1),
        "unit": "rays/s",
        "device": {"platform": platform, "kind": kind, "count": count},
    }))


if __name__ == "__main__":
    main()
