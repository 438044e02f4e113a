"""PyTorch port: scene containers, presets, stand-ins, light edits and the
interop path, held to the JAX package (equal arrays).  Also the rule that
the port imports no JAX.

The helpers here (``jax_scene``, ``scene_pair``) build one in-process scene
for both packages; the other ``test_torch_*`` files import them.
"""
import ast
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.scene import lights as jlights
from cg_raytracer_tpu_torch.interop import (CAMERA_LEAVES, SCENE_LEAVES,
                                            camera_from_numpy, scene_from_numpy)
from cg_raytracer_tpu_torch.scene import lights as tlights
from cg_raytracer_tpu_torch.scene import standins

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def port_leaves(obj):
    """Tensor fields of a port dataclass, depth first in field order (the
    JAX pytree's leaf order)."""
    out = []
    for name in obj.__dataclass_fields__:
        val = getattr(obj, name)
        out.extend(port_leaves(val) if hasattr(val, "__dataclass_fields__")
                   else [val.detach().cpu().numpy()])
    return out


def jax_scene(meshes, spheres=None, lights=()):
    sp = (jrt.Spheres(**{k: jnp.asarray(v) for k, v in spheres.items()})
          if spheres is not None else None)
    return jrt.make_scene(meshes, spheres=sp, point_lights=jrt.PointLights.of(*lights))


def jax_scene_named(name):
    if name == "mirror_box":
        return jax_scene(standins.mirror_box_meshes(), lights=standins.MIRROR_BOX_LIGHTS)
    if name == "mixed":
        return jax_scene(standins.mixed_meshes(), standins.mixed_spheres(),
                         standins.MIXED_LIGHTS)
    if name == "mixed_tris":
        return jax_scene(standins.mixed_meshes(), lights=standins.MIXED_LIGHTS + (
            ((-1.0, 1.5, 0.5), (0.5, 0.5, 0.5)),))
    return jrt.load_scene(name)


def scene_pair(name, device="cpu"):
    """(JAX scene, port scene): the port's built from the JAX leaves through interop."""
    j = jax_scene_named(name)
    return j, scene_from_numpy(jax_leaves(j), device=device)


def assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["mirror_box", "mixed", "spheres"])
def test_make_scene_matches_jax(name):
    j = jax_scene_named(name)
    if name == "mirror_box":
        t = trt.make_scene(standins.mirror_box_meshes(),
                           point_lights=trt.PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                           device="cpu")
    elif name == "mixed":
        t = trt.make_scene(standins.mixed_meshes(),
                           spheres=trt.Spheres(**{k: torch.as_tensor(v) for k, v in
                                                  standins.mixed_spheres().items()}),
                           point_lights=trt.PointLights.of(*standins.MIXED_LIGHTS),
                           device="cpu")
    else:
        t = trt.load_scene(name, device="cpu")
    assert_leaves_equal(jax_leaves(j), port_leaves(t))
    # interop builds the same scene from the JAX leaves
    assert_leaves_equal(port_leaves(scene_from_numpy(jax_leaves(j))), port_leaves(t))


def test_procedural_presets_match_jax():
    for name in ("teacup",):
        assert_leaves_equal(jax_leaves(jrt.load_scene(name)), port_leaves(trt.load_scene(name, device="cpu")))


def test_empty_scene_and_merge_meshes_match_jax():
    from cg_raytracer_tpu.scene.types import merge_meshes as jmerge
    from cg_raytracer_tpu_torch.scene.types import merge_meshes as tmerge

    for meshes in ([], standins.mixed_meshes()):
        jv = jmerge(meshes)
        tv = tmerge(meshes)
        for a, b in zip(jv[:4], tv[:4]):
            np.testing.assert_array_equal(a, b)
        assert_leaves_equal(jax_leaves(jv[4]), port_leaves(tv[4]))
    assert_leaves_equal(jax_leaves(jrt.make_scene()), port_leaves(trt.make_scene(device="cpu")))


@pytest.mark.parametrize("kwargs", [{}, dict(euler_deg=(0, 35, 5), dist=2.5, fovy_deg=40.0,
                                             aspect=1.5, look_at=(0.5, -0.2, 0.1))])
def test_camera_default_matches_jax(kwargs):
    j = jax_leaves(jrt.Camera.default(**kwargs))
    assert_leaves_equal(j, port_leaves(trt.Camera.default(**kwargs, device="cpu")))
    assert_leaves_equal(j, port_leaves(camera_from_numpy(j)))


def test_interop_rejects_wrong_leaf_count():
    leaves = jax_leaves(jax_scene_named("mixed"))
    assert len(leaves) == len(SCENE_LEAVES)
    with pytest.raises(ValueError):
        scene_from_numpy(leaves[:-1])
    with pytest.raises(ValueError):
        camera_from_numpy([np.zeros(3)] * (len(CAMERA_LEAVES) + 1))


def test_mirror_box_shape():
    scene = trt.make_scene(standins.mirror_box_meshes(),
                           point_lights=trt.PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                           device="cpu")
    assert scene.num_triangles == 32
    ks = scene.materials.ks[scene.tri_material.long()]
    assert bool((ks > 0.01).any(dim=1).any())  # a live mirror: depth 2 matters
    light = scene.point_lights.position
    assert light.shape == (1, 3)
    np.testing.assert_allclose(light[0].numpy(), [0.0, 0.58, 0.0])
    # In the box's own frame (undo the rotation that turns it to the camera),
    # the light lies inside the walls' half-side of 0.6.
    axes = standins._rotate(np.eye(3), (20.0, 20.0, 0.0))  # rows: rotated unit vectors
    local = axes.astype(np.float64) @ light[0].numpy().astype(np.float64)
    assert np.all(np.abs(local) < 0.6), local
    verts = np.stack([m["vertices"] for m in standins.mirror_box_meshes()[:5]])
    local_verts = verts.reshape(-1, 3).astype(np.float64) @ axes.T.astype(np.float64)
    np.testing.assert_allclose(np.abs(local_verts), 0.6, atol=1e-6)


OBJ = """mtllib box.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
usemtl red
f 1//1 2//1 3//1 4//1
usemtl white
f 1 2 5
f -1 -2 -3
"""
MTL = """newmtl red
Kd 0.8 0.1 0.1
Ks 0.2 0.2 0.2
Ns 16
newmtl white
Kd 0.7 0.7 0.7
d 0.5
"""


def test_load_obj_matches_jax(tmp_path):
    from cg_raytracer_tpu.scene.loader import load_obj as jload
    from cg_raytracer_tpu_torch.scene.loader import load_obj as tload

    (tmp_path / "box.obj").write_text(OBJ)
    (tmp_path / "box.mtl").write_text(MTL)
    path = str(tmp_path / "box.obj")
    for normalize in (False, True):
        jm = jload(path, normalize=normalize, use_native=False)
        tm = tload(path, normalize=normalize, use_native=False)
        assert len(jm) == len(tm) == 2
        for a, b in zip(jm, tm):
            for key in ("vertices", "normals", "triangles"):
                np.testing.assert_array_equal(a[key], b[key])
            assert a["material"] == b["material"]
    with pytest.raises(FileNotFoundError):
        tload(str(tmp_path / "missing.obj"))


def test_obj_presets_raise_without_data(tmp_path, monkeypatch):
    monkeypatch.setenv("CGRT_DATA_DIR", str(tmp_path))
    for name in ("cornell_box", "cube", "monkey"):
        with pytest.raises(FileNotFoundError):
            trt.load_scene(name, device="cpu")
    with pytest.raises(ValueError):
        trt.load_scene("no_such_scene", device="cpu")


def test_scene_device_and_to():
    scene = trt.load_scene("spheres", device="cpu")
    assert scene.device == torch.device("cpu")
    moved = scene.to("cpu")
    assert_leaves_equal(port_leaves(scene), port_leaves(moved))


def test_light_edits_match_jax():
    kw = dict(removes=(0,), add_points=((0.1, 0.2, 0.3, 1.0, 0.5, 0.25),),
              add_sphericals=((0.0, 1.0, 0.0, 0.2, 1.0, 1.0, 1.0),),
              index=2, position=(0.5, 0.5, 0.5), color=(0.2, 0.3, 0.4), radius=0.3)
    j, t = scene_pair("mixed_tris")
    assert_leaves_equal(jax_leaves(jlights.apply_edits(j, **kw)),
                        port_leaves(tlights.apply_edits(t, **kw)))
    j2 = jlights.apply_edits(j, index=1, position=(1.0, 2.0, 3.0))
    t2 = tlights.apply_edits(t, index=1, position=(1.0, 2.0, 3.0))
    assert_leaves_equal(jax_leaves(j2), port_leaves(t2))
    with pytest.raises(ValueError):
        tlights.set_light(t, 0, radius=1.0)
    with pytest.raises(IndexError):
        tlights.remove_light(t, 5)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "cg_raytracer_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "cg_raytracer_tpu"), (
                f"{path.relative_to(REPO)} imports {name}")


def test_csrc_is_packaged():
    text = (REPO / "pyproject.toml").read_text()
    assert "cg_raytracer_tpu_torch" in text and "csrc/*.cu" in text
    assert os.path.exists(REPO / "cg_raytracer_tpu_torch" / "csrc" / "sweep.cuh")


def test_entry_points_default_to_the_card():
    # load_scene, load_standin, make_scene and Camera.default put their
    # tensors on the card unless asked for the CPU; without a card they
    # raise and do not fall back.
    from cg_raytracer_tpu_torch.scene.presets import load_standin

    calls = (lambda: trt.load_scene("spheres"), lambda: load_standin("mirror_box"),
             lambda: trt.make_scene(standins.mirror_box_meshes()), trt.Camera.default)
    for call in calls:
        if torch.cuda.is_available():
            obj = call()
            assert obj.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert trt.Camera.default(device="cpu").device.type == "cpu"
