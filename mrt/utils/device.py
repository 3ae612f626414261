"""Which accelerator a measurement ran on.

A measurement names its device and never falls back to the CPU: a
rays/s taken on XLA's CPU backend says nothing about the card.
"""

from __future__ import annotations

import subprocess


def require_gpu(devices=None):
    """(platform, device_kind, count) of JAX's devices.

    Raises RuntimeError unless the first device is a GPU."""
    if devices is None:
        import jax

        devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {d.platform} "
            f"({d.device_kind}); this measurement needs the card")
    return d.platform, d.device_kind, len(devices)


def card_name_and_power_limit():
    """`nvidia-smi`'s "name, power.limit" line for each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
