"""Profiling and render statistics.

The reference's observability is wall-clock prints (reference:
src/main.rs:254,270) plus keeping debug symbols for external profilers
(Cargo.toml:25-26).  The equivalents here: `jax.profiler` traces
(viewable in XProf/TensorBoard) and integrator statistics derived from
the film.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


@contextlib.contextmanager
def trace(log_dir=None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class RenderStats:
    """Derived per-render statistics (SURVEY §5: per-bounce counters)."""
    samples: int
    camera_rays: int
    path_segments: int      # camera rays + scatter events
    mean_path_length: float
    wall_seconds: float

    @property
    def rays_per_sec(self):
        return self.camera_rays / max(self.wall_seconds, 1e-9)

    @property
    def segments_per_sec(self):
        return self.path_segments / max(self.wall_seconds, 1e-9)

    def __str__(self):
        return (f"{self.samples} spp, "
                f"{self.camera_rays / 1e6:.2f}M camera rays, "
                f"mean path {self.mean_path_length:.2f}, "
                f"{self.rays_per_sec / 1e6:.2f}M rays/s, "
                f"{self.segments_per_sec / 1e6:.2f}M segments/s")


def stats_from_film(film, wall_seconds):
    """Compute RenderStats from an accumulated film."""
    import numpy as np

    samples = int(film.samples)
    npix = film.width * film.height
    camera_rays = npix * samples
    scatters = int(np.asarray(film.depth_sum).sum())
    segments = camera_rays + scatters
    return RenderStats(
        samples=samples,
        camera_rays=camera_rays,
        path_segments=segments,
        mean_path_length=segments / max(camera_rays, 1),
        wall_seconds=wall_seconds,
    )


class Timer:
    """Wall-clock segment timer with named laps (ETA prints analogue,
    main.rs:129-139)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps = {}

    def lap(self, name):
        now = time.perf_counter()
        self.laps[name] = now - self.t0
        self.t0 = now
        return self.laps[name]
