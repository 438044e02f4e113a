"""The frame plan of a graphed ``render()`` (``models/whitted.py::
FramePlan``) and a graph's record of its inputs (``Graph.load_changed``),
on the CPU: ``graphs.Graph`` is replaced by a stand-in that runs the frame
eagerly on its static inputs at each replay, so the plan's checks, its
misses and the slots each call copies are those of the card's path.  The
card's own cases are in ``tests/test_torch_cuda.py``."""
import dataclasses

import pytest
import torch

from cg_raytracer_tpu_torch.models import whitted
from cg_raytracer_tpu_torch.ops.bvh import build_bvh
from cg_raytracer_tpu_torch.scene.presets import load_standin
from cg_raytracer_tpu_torch.scene.types import Camera
from cg_raytracer_tpu_torch.utils import graphs
from cg_raytracer_tpu_torch.utils.config import RenderConfig

CFG = RenderConfig(width=12, height=10)
SCENE_LEAVES = 18  # vertices .. spherical lights, then the camera's five
EULER = SCENE_LEAVES + 1


class _Handle:
    def reset(self):
        pass


class CpuGraph(graphs.Graph):
    """``graphs.Graph`` without the card: the frame runs eagerly on the
    graph's static inputs at each replay; ``copied``, the slots each load
    copied."""

    def __init__(self, fn, inputs, roots, device, warmup=None, hold=()):
        src = graphs.leaves(inputs)
        self.fn, self.hold, self.graph = fn, hold, _Handle()
        self.static = [x.detach().clone() for x in src]
        self.sources, self.versions = src, graphs._versions(src)
        self.writes_inputs = False
        self.args = graphs.rebuild(inputs, iter(self.static))
        self.copied = []

    def load_changed(self, src):
        stale = super().load_changed(src)
        self.copied.append(stale)
        return stale

    def replay(self, roots):
        return self.fn(*self.args, list(roots))


@pytest.fixture
def graphed(monkeypatch):
    """``render()``'s graphed route (``whitted._render_graphed``) of
    ``(scene, camera, cfg=CFG, accel=None)`` through a fresh cache of
    stand-in graphs -> (image, plan hit); ``resolved``: the resolutions run."""
    monkeypatch.setattr(graphs, "Graph", CpuGraph)
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache())
    resolved = []
    depth = whitted.effective_max_depth
    monkeypatch.setattr(whitted, "effective_max_depth",
                        lambda s, c: resolved.append(1) or depth(s, c))

    def call(scene, camera, cfg=CFG, accel=None):
        before = whitted.plan_counts()
        img = whitted._render_graphed(scene, camera, cfg, accel, None)
        after = whitted.plan_counts()
        assert after["calls"] == before["calls"] + 1
        return img, after["hits"] - before["hits"] == 1

    call.resolved = resolved
    return call


def _box():
    return load_standin("mirror_box", device="cpu")


def _camera(euler=(20.0, 20.0, 0.0)):
    return Camera.default(euler_deg=euler, aspect=1.2, device="cpu")


def _eager(scene, camera, cfg=CFG, accel=None):
    return whitted.render(scene, camera, cfg, accel=accel, jit=False)


def test_the_same_scene_hits_and_copies_only_the_moved_camera_leaf(graphed):
    box, cam = _box(), _camera()
    img, hit = graphed(box, cam)
    assert not hit and len(graphed.resolved) == 1
    graph = graphs.CACHE.plan.graph
    assert graph.copied == [[]]  # the capture's own inputs
    moved = dataclasses.replace(cam, euler=cam.euler + 0.05)
    img2, hit = graphed(box, moved)
    assert hit and len(graphed.resolved) == 1  # no resolution on a hit
    assert graph.copied[-1] == [EULER]
    assert torch.equal(img2, _eager(box, moved)) and not torch.equal(img, img2)
    img3, hit = graphed(box, moved)
    assert hit and graph.copied[-1] == [] and torch.equal(img3, img2)
    assert len(graphs.CACHE) == 1


def _edit_ks(box, cam, call):
    box.materials.ks.zero_()  # no material reflects: the depth is cut to 1
    return box, cam, None, 1


def _new_leaf(box, cam, call):
    box.materials.kd = box.materials.kd.clone()
    return box, cam, None, 2


def _edit_light(box, cam, call):
    box.point_lights.position.add_(0.1)
    return box, cam, None, 2


def _unequal_cfg(box, cam, call):
    return box, cam, dataclasses.replace(CFG, max_depth=1), 1


def _camera_shape(box, cam, call):
    return box, dataclasses.replace(cam, aspect=cam.aspect.reshape(1)), None, 2


def _cleared(box, cam, call):
    graphs.clear()
    return box, cam, None, 2


def _evicted(box, cam, call):
    for k in range(graphs.CACHE.capacity):  # the plan stays; its graph goes
        graphs.CACHE.put(("other", k), CpuGraph(None, (box, cam), [], "cpu"))
    return box, cam, None, 2


def _another_scene(box, cam, call):
    return _box(), cam, None, 2


@pytest.mark.parametrize("change", [_edit_ks, _new_leaf, _edit_light, _unequal_cfg,
                                    _camera_shape, _cleared, _evicted, _another_scene])
def test_a_change_misses_the_plan(change, graphed):
    box, cam = _box(), _camera()
    graphed(box, cam)
    assert graphed(box, cam)[1]
    graphed.resolved.clear()
    box, cam, cfg, depth = change(box, cam, graphed)
    img, hit = graphed(box, cam, cfg or CFG)
    assert not hit and len(graphed.resolved) == 1
    assert graphs.CACHE.plan.resolved.max_depth == depth
    assert torch.equal(img, _eager(box, cam, cfg or CFG))
    assert graphed(box, cam, cfg or CFG)[1]  # and the new plan hits


def test_an_equal_config_hits(graphed):
    box, cam = _box(), _camera()
    graphed(box, cam)
    assert graphed(box, cam, dataclasses.replace(CFG))[1]
    assert len(graphed.resolved) == 1


def test_another_accel_misses(graphed):
    box, cam = _box(), _camera()
    cfg = dataclasses.replace(CFG, backend="bvh")
    tree_a, tree_b = build_bvh(box), build_bvh(box)
    graphed(box, cam, cfg, tree_a)
    assert graphed(box, cam, cfg, tree_a)[1]
    img, hit = graphed(box, cam, cfg, tree_b)
    assert not hit and len(graphed.resolved) == 2 and len(graphs.CACHE) == 2
    assert torch.equal(img, _eager(box, cam, cfg, tree_b))
    assert graphed(box, cam, cfg, tree_b)[1]


def test_requires_grad_misses_and_still_raises(graphed):
    box, cam = _box(), _camera()
    graphed(box, cam)
    version = box.materials.kd._version
    box.materials.kd.requires_grad_()
    assert box.materials.kd._version == version  # invisible to the version: checked apart
    with pytest.raises(ValueError, match="jit=False"):
        graphed(box, cam)
    with torch.no_grad():
        assert graphed(box, cam)[1]  # no grad mode: the graph may replay it
    cam = dataclasses.replace(cam, euler=cam.euler.clone().requires_grad_())
    with pytest.raises(ValueError, match="jit=False"):
        graphed(box, cam)


def test_forgetting_an_owner_keeps_the_plan(graphed):
    box, cam = _box(), _camera()
    graphed(box, cam)
    graphs.forget(object())
    assert graphed(box, cam)[1]


def test_scenes_through_one_graph_copy_their_leaves_back(graphed):
    a, cam = _box(), _camera()
    b = _box()
    b.materials.kd.mul_(0.5)
    b.point_lights.position.add_(0.1)
    img_a, _ = graphed(a, cam)
    graph = graphs.CACHE.plan.graph
    img_b, hit = graphed(b, cam)
    assert not hit and graphs.CACHE.plan.graph is graph and len(graphs.CACHE) == 1
    assert graph.copied[-1] == list(range(SCENE_LEAVES))  # every scene leaf is B's
    img_a2, hit = graphed(a, cam)
    assert not hit and graph.copied[-1] == list(range(SCENE_LEAVES))
    assert torch.equal(img_a, _eager(a, cam)) and torch.equal(img_b, _eager(b, cam))
    assert torch.equal(img_a2, img_a) and not torch.equal(img_a, img_b)
    assert graphed(a, cam)[1] and graph.copied[-1] == []


def test_a_full_load_forgets_the_record():
    # ``Graph.load`` (a training chunk, ``fwd_bwd``) copies every slot and
    # leaves no record, so the next ``load_changed`` copies every slot too.
    box, cam = _box(), _camera()
    graph = CpuGraph(None, (box, cam), [], "cpu")
    src = graphs.leaves((box, cam))
    assert graph.load_changed(src) == []
    graph.load((box, cam))
    assert graph.load_changed(src) == list(range(len(src)))
    assert graph.load_changed(src) == []
    with torch.inference_mode():
        frozen = _camera()
    src = graphs.leaves((box, frozen))  # inference tensors keep no version: always copied
    assert graph.load_changed(src) == list(range(len(src)))
    assert graph.load_changed(src) == list(range(len(src)))
