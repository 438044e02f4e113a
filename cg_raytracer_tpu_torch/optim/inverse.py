"""Scene parameter sets for inverse rendering, as in
``cg_raytracer_tpu/optim/inverse.py``: which tensors a training step
differentiates, and how a step puts them back into the scene.

Parameter sets are dicts of tensors; ``apply_*`` rebuilds the scene with
``dataclasses.replace`` and leaves the given scene unchanged.  The optimiser
loop and its checkpoints are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..scene.types import PointLights, Scene


def vertex_params(scene: Scene) -> Dict:
    """Geometry parameter set: raw vertex positions."""
    return {"vertices": scene.vertices}


def apply_vertex_params(scene: Scene, params: Dict) -> Scene:
    return dataclasses.replace(scene, vertices=params["vertices"])


def material_params(scene: Scene) -> Dict:
    """Default parameter set: the material table, and the point lights' colors
    and positions when the scene has point lights."""
    params = {
        "kd": scene.materials.kd,
        "ks": scene.materials.ks,
        "shininess": scene.materials.shininess,
    }
    if scene.point_lights.position.shape[0] > 0:
        params["light_color"] = scene.point_lights.color
        params["light_position"] = scene.point_lights.position
    return params


def apply_material_params(scene: Scene, params: Dict) -> Scene:
    mats = dataclasses.replace(scene.materials, kd=params["kd"], ks=params["ks"],
                               shininess=params["shininess"])
    scene = dataclasses.replace(scene, materials=mats)
    if "light_color" in params:
        lights = PointLights(position=params["light_position"], color=params["light_color"])
        scene = dataclasses.replace(scene, point_lights=lights)
    return scene
