"""Render configuration.

The reference configures everything with compile-time consts and code
edits (reference: src/main.rs:37-54 — resolution, MAX_DEPTH, animation
length, scene selection by commenting lines).  Here it's a dataclass
loadable from CLI flags / JSON, the scene picked by name.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RenderConfig:
    scene: str = "rtiow"
    width: int = 1920                  # main.rs:43-45 (1080p 16:9)
    height: int = 1080
    max_depth: int = 50                # main.rs:37
    spp: int = 64
    samples_per_pass: int = 8
    seed: int = 1                      # main.rs:86 fastrand::seed(1)
    # Animation (main.rs:38-48)
    animate: bool = False
    fps: float = 30.0
    animation_seconds: float = 5.0
    samples_per_frame: int = 16
    output: str = "out.png"
    animation_dir: str = "animation"
    checkpoint: Optional[str] = None   # resume path (SURVEY §5 gap fill)
    denoise: bool = False
    display_mode: str = "default"      # default/denoise/depth/albedo/normal
    # Input record/replay (main.rs:50-51 READ_INPUT/WRITE_INPUT)
    read_input: Optional[str] = None
    write_input: Optional[str] = None
    # Multi-device
    mesh_tile: Optional[int] = None
    mesh_spp: int = 1
    # Profiling (SURVEY §5: jax.profiler traces)
    profile_dir: Optional[str] = None
    # Progressive preview: re-export the output PNG after every pass
    # (the headless stand-in for the reference's live window updates,
    # main.rs:274-278).
    preview: bool = False
    # Integrator: ray-regeneration persistent wavefront (fast path) vs
    # the batched loop (identical estimator).
    persistent: bool = True
    # Next-event estimation (beyond-reference): direct light sampling
    # for much faster convergence on emissive scenes.
    nee: bool = False
    # Russian roulette start depth (None = off, matching the reference);
    # unbiased early termination of low-energy paths.
    rr_depth: Optional[int] = None
    # Lane coherence sorting (Morton cell + direction octant) for the
    # persistent integrator: None/False = off, True = every step, k =
    # every k steps.  Permutes lanes only — the estimator and every RNG
    # draw are unchanged.
    sort_rays: Optional[bool] = None
    # Live viewer (the reference's interactive window, main.rs:297-532):
    # `--serve` starts a local HTTP page with runtime display-mode keys,
    # PNG export and quick-pass abort.
    serve: bool = False
    host: str = "127.0.0.1"
    port: int = 7860
    # Interactive play mode (with --serve): browser WASD/space keys feed
    # a per-frame InputCollection into Scene.generate — the reference's
    # playable Mario loop (main.rs:333-360, scenes/mario.rs:121-276).
    play: bool = False

    @property
    def aspect_ratio(self):
        return self.width / self.height

    @property
    def total_frames(self):
        return max(1, int(self.fps * self.animation_seconds))

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            return cls(**json.load(f))

    def to_json(self, path):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
