"""Progressive accumulation film + tonemapping + display modes.

Replaces the reference's `Image` (a mutex'd `(sample_count, Vec<(V3,u32)>)`,
reference: src/main.rs:598-638): here the film is a pure pytree
`(sum, depth_sum, samples)` and "merge" is just addition — order-invariant,
so shards can be `psum`'d.  Tonemap matches `to_rgb_bytes`
(main.rs:640-722): scale by 1/samples, gamma 1/2.2, clamp, with the same
Depth/Albedo/Normal display-mode transforms.

The film (plus the render seed) is also the checkpoint payload: saving
`(sum, depth_sum, samples)` and reloading resumes a progressive render
exactly — a capability the reference lacks (SURVEY §5: a stopped render
loses all samples).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import jax.numpy as jnp
from ..utils import struct


class DisplayMode(enum.Enum):
    """Display modes (reference: main.rs:534-541)."""
    DEFAULT = "default"
    DENOISE = "denoise"
    DEPTH = "depth"
    ALBEDO = "albedo"
    NORMAL = "normal"


@struct.dataclass
class Film:
    sum: jnp.ndarray         # (H,W,3) accumulated radiance
    depth_sum: jnp.ndarray   # (H,W)   accumulated bounce counts
    samples: jnp.ndarray     # scalar int32
    albedo: Optional[jnp.ndarray] = None  # (H,W,3) AOV guide
    normal: Optional[jnp.ndarray] = None  # (H,W,3) AOV guide

    @classmethod
    def create(cls, width, height):
        return cls(
            sum=jnp.zeros((height, width, 3), jnp.float32),
            depth_sum=jnp.zeros((height, width), jnp.int32),
            samples=jnp.zeros((), jnp.int32),
        )

    @property
    def width(self):
        return self.sum.shape[1]

    @property
    def height(self):
        return self.sum.shape[0]

    def merge(self, radiance, bounces):
        """Accumulate one 1-spp pass (reference: Image::merge,
        main.rs:629-638)."""
        return self.replace(
            sum=self.sum + radiance,
            depth_sum=self.depth_sum + bounces,
            samples=self.samples + 1,
        )

    def with_aov(self, albedo, normal):
        return self.replace(albedo=albedo, normal=normal)

    def clear(self):
        return self.replace(
            sum=jnp.zeros_like(self.sum),
            depth_sum=jnp.zeros_like(self.depth_sum),
            samples=jnp.zeros_like(self.samples),
        )

    # -- tonemap -----------------------------------------------------------

    def mean(self):
        return self.sum / jnp.maximum(self.samples, 1).astype(jnp.float32)

    def to_float_rgb(self, mode: DisplayMode = DisplayMode.DEFAULT,
                     denoiser=None):
        """Per-pixel float RGB in [0,1] (reference: to_rgb_bytes,
        main.rs:640-722).  Rows run bottom-up, like the reference's
        buffers; `io.save_png` flips on export (main.rs:760-783)."""
        if mode in (DisplayMode.DEFAULT, DisplayMode.DENOISE):
            out = jnp.clip(self.mean() ** (1.0 / 2.2), 0.0, 1.0)
            out = jnp.where(self.samples > 0, out, 0.0)
            if mode is DisplayMode.DENOISE and denoiser is not None:
                out = denoiser(out, self.albedo, self.normal)
            return out
        if mode is DisplayMode.DEPTH:
            # main.rs:655-666: normalize mean depth by its image max.
            max_depth = jnp.maximum(jnp.max(self.depth_sum), 1)
            depth = jnp.clip(self.depth_sum / max_depth, 0.0, 1.0)
            depth = jnp.where(self.samples > 0, depth, 0.0)
            return jnp.repeat(depth[..., None], 3, axis=-1)
        if mode is DisplayMode.ALBEDO:
            if self.albedo is None:
                return jnp.zeros_like(self.sum)
            return jnp.clip(self.albedo, 0.0, 1.0) ** (1.0 / 2.2)
        if mode is DisplayMode.NORMAL:
            if self.normal is None:
                return jnp.zeros_like(self.sum)
            return (self.normal + 1.0) / 2.0
        raise ValueError(f"unknown display mode {mode}")

    def to_rgb_bytes(self, mode: DisplayMode = DisplayMode.DEFAULT,
                     denoiser=None):
        """uint8 RGB rows-bottom-up, truncating like the reference's
        `(p * 255.0) as u8` (main.rs:717-720)."""
        floats = np.asarray(self.to_float_rgb(mode, denoiser=denoiser))
        return (floats * 255.0).astype(np.uint8)

    # -- checkpoint --------------------------------------------------------

    def save_state(self, path, seed=0):
        """Checkpoint the accumulator so a render can resume (SURVEY §5)."""
        np.savez(
            path,
            sum=np.asarray(self.sum),
            depth_sum=np.asarray(self.depth_sum),
            samples=np.asarray(self.samples),
            seed=np.asarray(seed, np.uint32),
            albedo=(np.asarray(self.albedo)
                    if self.albedo is not None else np.zeros(0)),
            normal=(np.asarray(self.normal)
                    if self.normal is not None else np.zeros(0)),
        )

    @classmethod
    def load_state(cls, path):
        """Returns (film, seed)."""
        z = np.load(path)
        film = cls(
            sum=jnp.asarray(z["sum"]),
            depth_sum=jnp.asarray(z["depth_sum"]),
            samples=jnp.asarray(z["samples"]),
            albedo=jnp.asarray(z["albedo"]) if z["albedo"].size else None,
            normal=jnp.asarray(z["normal"]) if z["normal"].size else None,
        )
        return film, int(z["seed"])
