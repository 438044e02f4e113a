"""Render configuration: the fields of ``cg_raytracer_tpu/utils/config.py::
RenderConfig`` that the render and its gradients read, under the same names,
defaults and errors.

The TPU auto-tuning knobs (tile rows, interleave, leaf widths, ray order,
``remat_shade``, ``bounce_resort``, ``shade_gather``, ...) are not carried
over: each was a measurement on a TPU.  ``anti_aliasing``, ``bloom`` and
``motion_blur`` exist so that a request for them fails loudly (their port is
ROADMAP A9) instead of being dropped.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800  # reference windowResolution (main.cpp:29)
    height: int = 800
    max_depth: int = 2  # reflection recursion cap (trace(), main.cpp:267)
    anti_aliasing: bool = False  # not ported: ROADMAP A9
    bloom: bool = False  # not ported: ROADMAP A9
    motion_blur: bool = False  # not ported: ROADMAP A9
    # 'auto' | 'brute' | 'cuda'.  'auto' resolves from the scene's device:
    # 'cuda' on CUDA tensors, 'brute' on CPU tensors.
    backend: str = "auto"
    # Declares that no gradients will be taken: eligible scenes then run the
    # whole forward trace in one kernel (ops/cuda_kernels.py::trace_cuda), and
    # differentiating the render raises.
    forward_only: bool = False
    # Two-phase gradient structure: phase 1 records every level's hits,
    # shadow bits and next rays with the scene detached; phase 2 runs the
    # differentiable shade over the records.  'auto' | 'on' | 'off';
    # 'auto' = 'off', as in the JAX package.
    grad_two_phase: str = "auto"
    # Phase-2 rays: 'exact' recomputes each bounce ray from the previous
    # level's differentiable surface (the reflected-origin vertex term
    # flows); 'recorded' takes phase 1's detached rays (that term is then
    # dropped; exact when no vertex is differentiated).  'auto' = 'exact'.
    two_phase_rays: str = "auto"
    # Fused shade kernel (ops/shade.py) in phase 2: 'auto' = on for a scene
    # on a CUDA device, off on the CPU; 'on' on the CPU runs its plain twin.
    shade_kernel: str = "auto"
    ray_chunk: int = 0  # >0: trace rays in chunks of this size
    tri_chunk: int = 2048  # triangle tile per brute-force sweep step
    reference_quirks: bool = False  # reproduce documented reference bugs
    # 'auto' on CPU: brute force up to this triangle count (the BVH beyond it
    # is ROADMAP A6).
    brute_force_max_tris: int = 4096
    # Cap of the card's brute-force kernels (their shared-memory tables);
    # past it the JAX package switches to BVH kernels (ROADMAP B5).
    pallas_brute_max_tris: int = 256

    def resolve_backend(self, num_tris: int, device: torch.device) -> str:
        """'brute' or 'cuda' for a scene of ``num_tris`` triangles on ``device``."""
        if self.backend not in ("auto", "brute", "cuda"):
            raise ValueError(f"backend must be 'auto' | 'brute' | 'cuda', got {self.backend!r}")
        on_card = torch.device(device).type == "cuda"
        kind = self.backend
        if kind == "auto":
            kind = "cuda" if on_card else "brute"
        if kind == "brute" and on_card:
            raise ValueError("backend='brute' is the CPU path; a scene on a CUDA "
                             "device renders with backend='cuda' (or 'auto')")
        if (kind == "brute" and self.backend == "auto"
                and num_tris > self.brute_force_max_tris):
            raise NotImplementedError(
                f"{num_tris} triangles exceed brute_force_max_tris="
                f"{self.brute_force_max_tris}; the BVH backend is not ported yet "
                f"(ROADMAP A6). Pass backend='brute' to sweep every triangle.")
        return kind

    def resolve_grad_two_phase(self) -> bool:
        if self.grad_two_phase not in ("auto", "on", "off"):
            raise ValueError(
                f"grad_two_phase must be 'auto' | 'on' | 'off', got "
                f"{self.grad_two_phase!r}")
        return self.grad_two_phase == "on"

    def resolve_two_phase_rays(self) -> str:
        if self.two_phase_rays not in ("auto", "exact", "recorded"):
            raise ValueError(
                f"two_phase_rays must be 'auto' | 'exact' | 'recorded', got "
                f"{self.two_phase_rays!r}")
        return "exact" if self.two_phase_rays == "auto" else self.two_phase_rays

    def resolve_shade_kernel(self, device: torch.device) -> bool:
        """'auto' = on for a scene on a CUDA device (the JAX package's
        'on for the TPU platform'), off on the CPU."""
        if self.shade_kernel not in ("auto", "on", "off"):
            raise ValueError(
                f"shade_kernel must be 'auto' | 'on' | 'off', got "
                f"{self.shade_kernel!r}")
        if self.shade_kernel != "auto":
            return self.shade_kernel == "on"
        return torch.device(device).type == "cuda"
