"""PyTorch port: the ``cgrt-torch`` command line on the CPU."""
import numpy as np
import pytest
import torch

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
    with pytest.raises(NotImplementedError, match="A9"):
        cli.main(["render", *SMALL, "--aa", "-o", str(tmp_path / "x.png")])
    # Spherical lights are ported (ROADMAP A8): --add-spherical-light renders
    # with --spp samples and lights the scene.
    plain, lit = tmp_path / "y0.png", tmp_path / "y.png"
    assert cli.main(["render", *SMALL, "-o", str(plain)]) == 0
    assert cli.main(["render", *SMALL, "--add-spherical-light", "0", "1", "0", "0.1", "1", "1",
                     "1", "--spp", "8", "-o", str(lit)]) == 0
    assert read_image(str(lit)).sum() > read_image(str(plain)).sum()


def test_cuda_device_has_no_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["render", "--scene", "spheres", "--width", "8", "--height", "8",
                  "-o", str(tmp_path / "z.png")])
