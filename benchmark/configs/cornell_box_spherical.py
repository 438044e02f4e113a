"""Geometry of the ``cornell_box_spherical`` configuration: the same
32-triangle stand-in box as the ``cornell_box`` configuration
(``configs/cornell_box.py``), since upstream's cornell_box_spherical_light
case loads the same OBJ as its cornell_box case."""
from __future__ import annotations

import importlib.util
import os

_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cornell_box.py")
_SPEC = importlib.util.spec_from_file_location("bench_geometry_cornell_box_shared", _PATH)
_BOX = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_BOX)

meshes = _BOX.meshes
