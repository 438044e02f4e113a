"""Light editing: the headless equivalent of the reference's ImGui light editor
(main.cpp:812-876), as in ``cg_raytracer_tpu/scene/lights.py``.

Lights are addressed by one index over [point lights..., spherical lights...],
the order of the reference's "Selected light" combo.  Each edit returns a new
Scene; tensors stay on the scene's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .types import PointLights, Scene, SphericalLights

# Reference defaults for newly added lights (main.cpp:856-864).
DEFAULT_POSITION = (0.0, 0.0, 0.0)
DEFAULT_COLOR = (1.0, 1.0, 1.0)
DEFAULT_RADIUS = 0.1


def _row(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device).reshape(1, -1)


def num_lights(scene: Scene) -> int:
    """Editable lights, point and spherical: the combo's length."""
    return scene.point_lights.position.shape[0] + scene.spherical_lights.position.shape[0]


def _split_index(scene: Scene, index: int):
    """Unified index -> ('point'|'spherical', local index); raises IndexError."""
    np_ = scene.point_lights.position.shape[0]
    ns = scene.spherical_lights.position.shape[0]
    if not (0 <= index < np_ + ns):
        raise IndexError(f"light index {index} out of range (scene has {np_} point + "
                         f"{ns} spherical lights)")
    return ("point", index) if index < np_ else ("spherical", index - np_)


def add_point_light(scene: Scene, position=DEFAULT_POSITION, color=DEFAULT_COLOR) -> Scene:
    pl = scene.point_lights
    return dataclasses.replace(scene, point_lights=PointLights(
        position=torch.cat([pl.position, _row(position, pl.position)]),
        color=torch.cat([pl.color, _row(color, pl.color)])))


def add_spherical_light(scene: Scene, position=DEFAULT_POSITION,
                        radius: float = DEFAULT_RADIUS, color=DEFAULT_COLOR) -> Scene:
    sl = scene.spherical_lights
    return dataclasses.replace(scene, spherical_lights=SphericalLights(
        position=torch.cat([sl.position, _row(position, sl.position)]),
        radius=torch.cat([sl.radius, _row([radius], sl.radius).reshape(1)]),
        color=torch.cat([sl.color, _row(color, sl.color)])))


def remove_light(scene: Scene, index: int) -> Scene:
    kind, li = _split_index(scene, index)
    lights = scene.point_lights if kind == "point" else scene.spherical_lights
    keep = torch.arange(lights.position.shape[0], device=lights.position.device) != li
    kept = dataclasses.replace(lights, **{
        f.name: getattr(lights, f.name)[keep] for f in dataclasses.fields(lights)})
    field = "point_lights" if kind == "point" else "spherical_lights"
    return dataclasses.replace(scene, **{field: kept})


def set_light(scene: Scene, index: int, position=None, color=None,
              radius: Optional[float] = None) -> Scene:
    """Edit the selected light's position/color (+ radius for spherical lights
    only, like the editor's conditional radius widget, main.cpp:833-841)."""
    kind, li = _split_index(scene, index)
    if kind == "point" and radius is not None:
        raise ValueError(f"light {index} is a point light; radius applies only to "
                         f"spherical lights")
    lights = scene.point_lights if kind == "point" else scene.spherical_lights
    changes = {}
    for name, value in (("position", position), ("color", color), ("radius", radius)):
        if value is None:
            continue
        col = getattr(lights, name).clone()
        col[li] = torch.as_tensor(value, dtype=torch.float32)
        changes[name] = col
    field = "point_lights" if kind == "point" else "spherical_lights"
    return dataclasses.replace(scene, **{field: dataclasses.replace(lights, **changes)})


def apply_edits(scene: Scene, removes: Sequence[int] = (),
                add_points: Sequence[Sequence[float]] = (),
                add_sphericals: Sequence[Sequence[float]] = (),
                index: int = 0, position=None, color=None,
                radius: Optional[float] = None) -> Scene:
    """A scripted run of the editor: removes (each re-indexing, like repeated
    button presses), then adds, then an edit of the selected light.
    ``add_points``: (x, y, z, r, g, b); ``add_sphericals``: (x, y, z, radius, r, g, b)."""
    for ri in removes:
        scene = remove_light(scene, int(ri))
    for spec in add_points:
        x, y, z, r_, g, b = (float(v) for v in spec)
        scene = add_point_light(scene, position=(x, y, z), color=(r_, g, b))
    for spec in add_sphericals:
        x, y, z, rad, r_, g, b = (float(v) for v in spec)
        scene = add_spherical_light(scene, position=(x, y, z), radius=rad, color=(r_, g, b))
    if position is not None or color is not None or radius is not None:
        scene = set_light(scene, index, position=position, color=color, radius=radius)
    return scene
