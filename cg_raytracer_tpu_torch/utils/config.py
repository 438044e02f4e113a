"""Render configuration: the fields of ``cg_raytracer_tpu/utils/config.py::
RenderConfig`` that the render and its gradients read, under the same names,
defaults and errors.

The TPU auto-tuning knobs (tile rows, interleave, pop mode, ray order,
``remat_shade``, ``bounce_resort``, ``shade_gather``, ``soft_cone_interleave``,
...) are not carried over: each was a measurement on a TPU.  The BVH leaf size is this port's own
knob (``bvh_max_leaf``), for the same reason.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800  # reference windowResolution (main.cpp:29)
    height: int = 800
    max_depth: int = 2  # reflection recursion cap (trace(), main.cpp:267)
    anti_aliasing: bool = False  # 2x2 supersampling (ops/effects.py)
    bloom: bool = False  # threshold + 21x21 box blur, added back
    motion_blur: bool = False  # 15 lookAt jitters of +0.01 x, averaged
    soft_shadow_samples: int = 200  # shadow rays per spherical-light shading (main.cpp:176)
    soft_shadow_chunk: int = 20  # samples per step of the scan over the any-hit oracle
    # Spherical-light soft shadows through the sampler kernels (ops/soft.py):
    # 'auto' = on for a scene on a CUDA device, off on the CPU (the scan over
    # the any-hit oracle); 'on' on the CPU runs the kernels' plain twins.
    soft_shadow_kernel: str = "auto"
    # The tree sampler's route: 'cone' walks the soft tree (AccelBundle.soft,
    # at the primary tree's width); 'sample' walks the primary tree and, as in
    # the JAX package, makes it binary.  On the card both run one thread per
    # (point, sample) and count the same.  'auto' = 'cone'.
    soft_shadow_tile: str = "auto"
    # The cone sampler's tree: leaf size (0 = auto) and split rule ('auto' |
    # 'median' | 'sah').  'auto' takes the primary tree's value, and where
    # both match the sampler walks the primary tree itself (no second build).
    soft_bvh_max_leaf: int = 0
    soft_bvh_builder: str = "auto"
    # 'auto' | 'brute' | 'bvh' | 'cuda'.  'auto' resolves from the scene's
    # device: 'cuda' on CUDA tensors; on CPU tensors 'brute' up to
    # brute_force_max_tris triangles and 'bvh' (the CPU traversal of
    # ops/bvh.py) beyond.
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
    # 'auto' on CPU: brute force up to this triangle count, the BVH beyond.
    brute_force_max_tris: int = 4096
    # The card: the brute-force kernels (shared-memory tables) up to this
    # count, the 4-wide BVH kernels (ops/bvh4.py) beyond.
    pallas_brute_max_tris: int = 256
    # BVH split rule: 'auto' | 'median' (the reference's, bvh.cpp:192-207) |
    # 'sah' (binned surface-area heuristic).  'auto' = 'sah' where the 4-wide
    # kernels run, else 'median', as the JAX package resolves it.
    bvh_builder: str = "auto"
    # Triangles per leaf of the card's tree; 0 = auto = 4 (ops/bvh.py
    # DEFAULT_MAX_LEAF).  The JAX package's 56 was a TPU measurement.
    bvh_max_leaf: int = 0
    # Node width of the card's tree up to VMEM_MAX_TRIS triangles: 'auto' |
    # '2' (the binary tree) | '4' | '8' (ops/bvh4.py collapse_bvhw); past it
    # bvh_wide_hbm: 'auto' | '2' | '4'.  One kernel walks every width.  Both
    # autos are '4', the JAX package's; the H100's numbers for the other
    # widths are in PERF.md.
    bvh_wide: str = "auto"
    bvh_wide_hbm: str = "auto"
    # Route forward_only renders past the trace kernel's cap through the
    # two-phase records and the shade kernel: 'auto' | 'on' | 'off'.  'auto'
    # is resolved by models.whitted.resolve_fwd_shade_kernel (render(),
    # run_bench): 'on' where depth 2 runs over a scene whose triangles are
    # reflective in more than 5% (the JAX package's rule); here 'auto' = 'off'.
    fwd_shade_kernel: str = "auto"

    def resolve_backend(self, num_tris: int, device: torch.device) -> str:
        """'brute', 'bvh' or 'cuda' for a scene of ``num_tris`` triangles on ``device``."""
        if self.backend not in ("auto", "brute", "bvh", "cuda"):
            raise ValueError(f"backend must be 'auto' | 'brute' | 'bvh' | 'cuda', got "
                             f"{self.backend!r}")
        on_card = torch.device(device).type == "cuda"
        if self.backend in ("brute", "bvh") and on_card:
            raise ValueError(f"backend={self.backend!r} is a CPU path; a scene on a CUDA "
                             f"device renders with backend='cuda' (or 'auto')")
        if self.backend != "auto":
            return self.backend
        if on_card:
            return "cuda"
        return "brute" if num_tris <= self.brute_force_max_tris else "bvh"

    def resolve_bvh_builder(self, num_tris: int, device: torch.device) -> str:
        if self.bvh_builder not in ("auto", "median", "sah"):
            raise ValueError(f"bvh_builder must be 'auto' | 'median' | 'sah', got "
                             f"{self.bvh_builder!r}")
        if self.bvh_builder != "auto":
            return self.bvh_builder
        from ..ops.bvh4 import VMEM_MAX_TRIS

        if (self.resolve_backend(num_tris, device) == "cuda"
                and self.pallas_brute_max_tris < num_tris <= VMEM_MAX_TRIS):
            return "sah"
        return "median"

    def resolve_bvh_max_leaf(self) -> int:
        if self.bvh_max_leaf < 0:
            raise ValueError(f"bvh_max_leaf must be positive (0 = auto), got {self.bvh_max_leaf}")
        from ..ops.bvh import DEFAULT_MAX_LEAF

        return self.bvh_max_leaf or DEFAULT_MAX_LEAF

    def resolve_soft_shadow_kernel(self, device: torch.device) -> bool:
        """'auto' = on for a scene on a CUDA device, off on the CPU."""
        if self.soft_shadow_kernel not in ("auto", "on", "off"):
            raise ValueError(
                f"soft_shadow_kernel must be 'auto' | 'on' | 'off', got "
                f"{self.soft_shadow_kernel!r}")
        if self.soft_shadow_kernel != "auto":
            return self.soft_shadow_kernel == "on"
        return torch.device(device).type == "cuda"

    def resolve_soft_shadow_tile(self) -> str:
        if self.soft_shadow_tile not in ("auto", "sample", "cone"):
            raise ValueError(
                f"soft_shadow_tile must be 'auto' | 'sample' | 'cone', got "
                f"{self.soft_shadow_tile!r}")
        return "cone" if self.soft_shadow_tile == "auto" else self.soft_shadow_tile

    def resolve_bvh_wide(self) -> str:
        if self.bvh_wide not in ("auto", "2", "4", "8"):
            raise ValueError(
                f"bvh_wide must be 'auto' | '2' | '4' | '8', got "
                f"{self.bvh_wide!r}")
        return "4" if self.bvh_wide == "auto" else self.bvh_wide

    def resolve_bvh_wide_hbm(self) -> str:
        if self.bvh_wide_hbm not in ("auto", "2", "4"):
            raise ValueError(
                f"bvh_wide_hbm must be 'auto' | '2' | '4', got "
                f"{self.bvh_wide_hbm!r}")
        return "4" if self.bvh_wide_hbm == "auto" else self.bvh_wide_hbm

    def resolve_soft_bvh_max_leaf(self) -> int:
        if self.soft_bvh_max_leaf:
            if self.soft_bvh_max_leaf < 1:
                raise ValueError("soft_bvh_max_leaf must be positive")
            return self.soft_bvh_max_leaf
        return self.resolve_bvh_max_leaf()

    def resolve_soft_bvh_builder(self, num_tris: int, device: torch.device) -> str:
        if self.soft_bvh_builder not in ("auto", "median", "sah"):
            raise ValueError(
                f"soft_bvh_builder must be 'auto' | 'median' | 'sah', got "
                f"{self.soft_bvh_builder!r}")
        if self.soft_bvh_builder != "auto":
            return self.soft_bvh_builder
        return self.resolve_bvh_builder(num_tris, device)

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
