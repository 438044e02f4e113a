"""Geometry of the ``teacup_spherical`` configuration: the same lathed cup
as the ``teacup`` configuration (``configs/teacup.py``), since the light
editor changes the lights of the loaded scene and nothing of its meshes."""
from __future__ import annotations

import importlib.util
import os

_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "teacup.py")
_SPEC = importlib.util.spec_from_file_location("bench_geometry_teacup_shared", _PATH)
_CUP = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_CUP)

meshes = _CUP.meshes
