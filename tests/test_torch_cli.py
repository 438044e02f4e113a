"""PyTorch port: the ``cgrt-torch`` command line on the CPU."""
import argparse

import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
from cg_raytracer_tpu_torch import cli
from cg_raytracer_tpu_torch.scene.presets import SCENE_NAMES
from cg_raytracer_tpu_torch.utils.image import read_image

SMALL = ["--scene", "spheres", "--device", "cpu", "--width", "24", "--height", "20"]


def test_render_writes_png(tmp_path, capsys):
    out = tmp_path / "spheres.png"
    assert cli.main(["render", *SMALL, "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "Time to render image:" in text and "primary rays/s" in text
    img = read_image(str(out))
    assert img.shape == (20, 24, 3)
    assert (img.max(axis=-1) > 0.02).mean() > 0.05


def test_render_bmp_and_light_edit(tmp_path):
    base, moved = tmp_path / "a.bmp", tmp_path / "b.bmp"
    assert cli.main(["render", *SMALL, "-o", str(base)]) == 0
    assert cli.main(["render", *SMALL, "--light-pos", "-3", "2", "3", "-o", str(moved)]) == 0
    assert base.read_bytes()[:2] == b"BM"
    assert not np.array_equal(read_image(str(base)), read_image(str(moved)))


def test_list_scenes(capsys):
    assert cli.main(["list-scenes"]) == 0
    assert capsys.readouterr().out.split() == list(SCENE_NAMES)


def test_unported_flags_raise(tmp_path):
    # The effects are ported (ROADMAP A9): --aa --bloom --motion-blur write
    # the image JAX renders (8-bit PNGs: within one step on 99.5% of pixels),
    # and --profile a Chrome trace of the timed render.
    out, trace = tmp_path / "x.png", tmp_path / "trace"
    assert cli.main(["render", *SMALL, "--aa", "--bloom", "--motion-blur", "--profile",
                     str(trace), "-o", str(out)]) == 0
    img = read_image(str(out))
    assert img.shape == (20, 24, 3)
    jcfg = jrt.RenderConfig(width=24, height=20, anti_aliasing=True, bloom=True,
                            motion_blur=True, backend="brute")
    ref = np.clip(np.asarray(jrt.render(jrt.load_scene("spheres"),
                                        jrt.Camera.default(aspect=24 / 20), jcfg)), 0, 1)
    assert (np.abs(img - ref).max(axis=-1) <= 1.5 / 255).mean() >= 0.995
    traces = list(trace.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    # Spherical lights are ported (ROADMAP A8): --add-spherical-light renders
    # with --spp samples and lights the scene.
    plain, lit = tmp_path / "y0.png", tmp_path / "y.png"
    assert cli.main(["render", *SMALL, "-o", str(plain)]) == 0
    assert cli.main(["render", *SMALL, "--add-spherical-light", "0", "1", "0", "0.1", "1", "1",
                     "1", "--spp", "8", "-o", str(lit)]) == 0
    assert read_image(str(lit)).sum() > read_image(str(plain)).sum()


def test_soft_shadow_kernel_flag(tmp_path):
    # 'on' samples the spherical light through the kernels' plain twins on the
    # CPU, 'off' through the scan over the any-hit oracle: one sample stream.
    box = ["--scene", "mirror_box", "--device", "cpu", "--width", "24", "--height", "20",
           "--backend", "cuda", "--add-spherical-light", "0", "0.4", "0", "0.1", "1", "1", "1",
           "--spp", "8"]
    parser = argparse.ArgumentParser()
    cli._add_common(parser)
    imgs = []
    for kernel in ("on", "off"):
        args = parser.parse_args([*box, "--soft-shadow-kernel", kernel])
        assert cli._build(args)[2].soft_shadow_kernel == kernel
        out = tmp_path / f"{kernel}.png"
        assert cli.main(["render", *box, "--soft-shadow-kernel", kernel, "-o", str(out)]) == 0
        imgs.append(read_image(str(out)))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].max() > 0.1
    with pytest.raises(SystemExit):
        parser.parse_args([*box, "--soft-shadow-kernel", "maybe"])


def test_cuda_device_has_no_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["render", "--scene", "spheres", "--width", "8", "--height", "8",
                  "-o", str(tmp_path / "z.png")])
