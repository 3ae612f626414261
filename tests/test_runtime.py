"""Runtime layer: CLI driver, config, input record/replay, denoiser."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from mrt.runtime.config import RenderConfig
from mrt.runtime.input import InputCollection, InputRecorder, InputReplay
from mrt.runtime.denoise import denoise


class TestConfig:
    def test_json_roundtrip(self, tmp_path):
        c = RenderConfig(scene="cornell", width=64, height=64, spp=4)
        p = str(tmp_path / "c.json")
        c.to_json(p)
        c2 = RenderConfig.from_json(p)
        assert c2 == c

    def test_defaults_match_reference(self):
        c = RenderConfig()
        assert (c.width, c.height) == (1920, 1080)  # main.rs:43-45
        assert c.max_depth == 50                     # main.rs:37
        assert c.seed == 1                           # main.rs:86


class TestInput:
    def test_record_replay_roundtrip(self, tmp_path):
        rec = InputRecorder()
        frames = [InputCollection(stick_x=0.5, button_a=True),
                  InputCollection(stick_y=-1.0, button_z=True),
                  InputCollection()]
        for f in frames:
            rec.record(f)
        p = str(tmp_path / "input.bin")
        rec.save(p)
        rep = InputReplay(p)
        for i, f in enumerate(frames):
            assert rep.frame(i) == f
        # Past the end: hold last frame (mario.rs:331-343).
        assert rep.frame(99) == frames[-1]


class TestDenoiser:
    def test_reduces_noise_preserves_edges(self, rng):
        h = w = 64
        clean = np.zeros((h, w, 3), np.float32)
        clean[:, w // 2:] = 0.8          # a hard vertical edge
        albedo = clean.copy()
        normal = np.zeros((h, w, 3), np.float32)
        normal[..., 2] = 1.0
        noisy = clean + rng.normal(0, 0.1, clean.shape).astype(np.float32)
        out = np.asarray(denoise(jnp.asarray(noisy), jnp.asarray(albedo),
                                 jnp.asarray(normal)))
        # Noise reduced in flat regions...
        left_std = out[:, :w // 2 - 4].std()
        assert left_std < noisy[:, :w // 2 - 4].std() * 0.5
        # ...edge preserved (albedo guide forbids cross-edge blur).
        edge_contrast = (out[:, w // 2 + 2].mean()
                         - out[:, w // 2 - 3].mean())
        assert edge_contrast > 0.6


class TestDriver:
    def test_single_frame_cli(self, tmp_path):
        from mrt.runtime.driver import run

        out = str(tmp_path / "frame.png")
        config = RenderConfig(scene="rtiow", width=32, height=18, spp=2,
                              max_depth=4, samples_per_pass=2, output=out)
        logs = []
        run(config, log=logs.append)
        assert os.path.exists(out)
        from mrt.runtime.io import load_png
        assert load_png(out).shape == (18, 32, 4)

    def test_checkpoint_resume_via_driver(self, tmp_path):
        from mrt.runtime.driver import run

        out = str(tmp_path / "frame.png")
        ckpt = str(tmp_path / "state.npz")
        config = RenderConfig(scene="rtiow", width=16, height=9, spp=2,
                              max_depth=4, samples_per_pass=2, output=out,
                              checkpoint=ckpt)
        film1 = run(config, log=lambda *a: None)
        assert int(film1.samples) == 2
        config2 = RenderConfig(scene="rtiow", width=16, height=9, spp=4,
                               max_depth=4, samples_per_pass=2,
                               output=out, checkpoint=ckpt)
        film2 = run(config2, log=lambda *a: None)
        assert int(film2.samples) == 4

    def test_animation_frames(self, tmp_path):
        from mrt.runtime.driver import run

        config = RenderConfig(
            scene="rtiow", width=16, height=9, max_depth=3,
            samples_per_frame=1, animate=True, fps=2.0,
            animation_seconds=1.0,
            animation_dir=str(tmp_path / "anim"))
        run(config, log=lambda *a: None)
        assert os.path.exists(str(tmp_path / "anim" / "frame_00000.png"))
        assert os.path.exists(str(tmp_path / "anim" / "frame_00001.png"))

    def test_cli_parser(self):
        from mrt.__main__ import build_parser

        args = build_parser().parse_args(
            ["--scene", "cornell", "--spp", "16", "-o", "x.png",
             "--mesh-tile", "4"])
        assert args.scene == "cornell"
        assert args.spp == 16
        assert args.mesh_tile == 4


class TestDynamicScene:
    def test_input_moves_player(self):
        from mrt.scenes.playground import Playground

        sc = Playground()
        inp = InputCollection(stick_x=1.0)
        sc.generate(0.0, 0, inp)
        x_after_1 = float(sc.state.pos[0])
        sc.generate(0.03, 1, inp)
        assert float(sc.state.pos[0]) > x_after_1 > 0.0

    def test_replay_is_deterministic(self, tmp_path):
        from mrt.scenes.playground import Playground

        frames = [InputCollection(stick_x=0.5, button_a=(i == 3))
                  for i in range(8)]
        rec = InputRecorder()
        for f in frames:
            rec.record(f)
        p = str(tmp_path / "in.bin")
        rec.save(p)

        def run_with(source):
            sc = Playground()
            for i in range(8):
                sc.generate(i / 8.0, i, source(i))
            return sc.state.pos.copy()

        live = run_with(lambda i: frames[i])
        replay = InputReplay(p)
        replayed = run_with(lambda i: replay.frame(i))
        np.testing.assert_array_equal(live, replayed)

    def test_platform_animates(self):
        from mrt.scenes.playground import Playground

        from mrt.scenes.playground import platform_state

        sc = Playground()
        # Instance order: level model (0), dielectric platform (1),
        # player model (2).  The platform oscillates on a slow sine
        # (mario.rs:138-155) — compare distant frames.
        s0, _ = sc.generate(0.0, 0, None)
        s1, _ = sc.generate(2.0, 60, None)
        t0 = np.asarray(s0.tlas.transform)[1, :3, 3]
        t1 = np.asarray(s1.tlas.transform)[1, :3, 3]
        assert np.linalg.norm(t1 - t0) > 1.0
        np.testing.assert_allclose(t0, platform_state(0)[0], atol=1e-5)
        np.testing.assert_allclose(t1, platform_state(60)[0], atol=1e-5)


class TestElasticRecovery:
    def test_retry_resumes_from_checkpoint(self, tmp_path, monkeypatch):
        """A device fault mid-render resumes from the last checkpointed
        pass instead of starting over (SURVEY §5 gap)."""
        from mrt.runtime import driver as drv

        out = str(tmp_path / "f.png")
        ckpt = str(tmp_path / "s.npz")
        config = RenderConfig(scene="rtiow", width=16, height=9, spp=4,
                              max_depth=3, samples_per_pass=2,
                              output=out, checkpoint=ckpt)
        calls = {"n": 0}
        real = drv.render_frame

        def flaky(scene, camera, cfg, film=None, progress=None):
            calls["n"] += 1
            if calls["n"] == 1:
                # Simulate a device fault after the first pass: render 2
                # spp, checkpoint them via progress, then die.
                f = real(scene, camera,
                         __import__("dataclasses").replace(cfg, spp=2),
                         film=film, progress=progress)
                if progress:
                    progress(f)
                raise RuntimeError("device error (simulated)")
            return real(scene, camera, cfg, film=film, progress=progress)

        monkeypatch.setattr(drv, "render_frame", flaky)
        logs = []
        film = drv.run(config, log=logs.append)
        assert int(film.samples) == 4
        assert calls["n"] == 2
        assert any("resuming from checkpoint" in l for l in logs)


def test_denoiser_quality_on_render():
    """Quantify denoiser quality on a real noisy render (VERDICT round
    1: the OIDN-substitute's gap was never measured): the AOV-guided
    a-trous filter must cut MSE vs a converged reference by >=2x at
    4 spp on the Cornell box."""
    import golden_scenes as G
    from mrt.runtime.render import render

    scene, camera = G.cornell()
    w = h = 32
    ref = np.asarray(render(scene, camera, w, h, spp=256, max_depth=6,
                            seed=11).mean())
    noisy_film = render(scene, camera, w, h, spp=4, max_depth=6,
                        seed=3, with_aov=True)
    noisy = np.asarray(noisy_film.mean())
    out = np.asarray(denoise(jnp.asarray(noisy),
                             jnp.asarray(noisy_film.albedo),
                             jnp.asarray(noisy_film.normal)))
    mse_noisy = float(((noisy - ref) ** 2).mean())
    mse_denoised = float(((out - ref) ** 2).mean())
    assert mse_denoised < 0.5 * mse_noisy, (mse_noisy, mse_denoised)
