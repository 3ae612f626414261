"""Multi-process distributed rendering: 2 CPU processes, a process-
spanning (tile, spp) mesh via `jax.distributed.initialize`, equality
with the single-process render (exact depth counts; radiance to float
accumulation order) (SURVEY §7 step 6; round-1 left
`init_distributed` untested)."""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single():
    port = _free_port()
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               MRT_NO_COMPILE_CACHE="1")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "DISTRIBUTED_OK" in outs[0], outs[0][-3000:]
