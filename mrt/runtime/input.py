"""Frame input state + record/replay.

The reference polls a gamepad into an `InputCollection` shared with the
render thread (reference: src/main.rs:333-360,500-532) and the Mario
scene serialises per-frame input to `record_input.bin` for reproducible
animations (scenes/mario.rs:318-343, flags main.rs:50-51).  Headless
accelerator rendering has no gamepad; the same capability here is a per-frame
input struct with binary record/replay so dynamic scenes stay
reproducible.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List


@dataclasses.dataclass
class InputCollection:
    """One frame of controller state."""
    stick_x: float = 0.0
    stick_y: float = 0.0
    cam_x: float = 0.0
    cam_z: float = 0.0
    button_a: bool = False
    button_b: bool = False
    button_z: bool = False

    _FMT = "<ffff???"

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.stick_x, self.stick_y,
                           self.cam_x, self.cam_z, self.button_a,
                           self.button_b, self.button_z)

    @classmethod
    def unpack(cls, data: bytes) -> "InputCollection":
        vals = struct.unpack(cls._FMT, data)
        return cls(*vals)

    @classmethod
    def size(cls) -> int:
        return struct.calcsize(cls._FMT)


class InputRecorder:
    """WRITE_INPUT-mode accumulation (mario.rs:318-330)."""

    def __init__(self):
        self.frames: List[InputCollection] = []

    def record(self, inp: InputCollection):
        self.frames.append(inp)

    def save(self, path):
        with open(path, "wb") as f:
            for inp in self.frames:
                f.write(inp.pack())


class InputReplay:
    """READ_INPUT-mode playback (mario.rs:331-343): returns the recorded
    frame, holding the last one past the end."""

    def __init__(self, path):
        size = InputCollection.size()
        self.frames = []
        with open(path, "rb") as f:
            while True:
                chunk = f.read(size)
                if len(chunk) < size:
                    break
                self.frames.append(InputCollection.unpack(chunk))

    def frame(self, index) -> InputCollection:
        if not self.frames:
            return InputCollection()
        return self.frames[min(index, len(self.frames) - 1)]
