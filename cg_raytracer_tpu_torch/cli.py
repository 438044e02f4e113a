"""Command-line interface of the PyTorch port (``cgrt-torch``): ``render``,
``optimize``, ``bench`` and ``list-scenes`` with the flags of
``cg_raytracer_tpu/cli.py``, plus ``--device``.

``render`` writes the image and prints the wall-clock time like the
reference's "Time to render image: ... milliseconds" (main.cpp:796), after a
warm-up render (kernel build and first launches excluded, like the
reference's BVH build; a mesh scene's tree is built once, in the warm-up);
``--aa``, ``--bloom`` and ``--motion-blur`` turn on the effects, and
``--profile DIR`` writes a Chrome trace of the timed render into DIR.
``optimize`` fits the scene's materials and point lights to a target image
(``optim/inverse.py::optimize``, npz checkpoint and resume with
``--checkpoint``) and prints the final loss; ``--output`` renders the
optimised scene.  ``bench`` prints ``run_bench``'s forward result as one
JSON line (the card only).  ``--scene`` takes a preset (``list-scenes``) or
a stand-in of ``scene/presets.py::STANDIN_NAMES`` (``mirror_box`` for the
absent ``cornell_box`` OBJ).  ``--device`` defaults to ``cuda``; there is no
fallback to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="cornell_box",
                   help="preset (see list-scenes) or stand-in (mirror_box, spherical_box, "
                        "spherical_teacup)")
    p.add_argument("--data-dir", default=None, help="OBJ/MTL directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on ('cuda', 'cuda:1', 'cpu')")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--max-bounces", type=int, default=2)
    p.add_argument("--backend", default="auto", choices=["auto", "brute", "bvh", "cuda"])
    p.add_argument("--spp", type=int, default=200,
                   help="soft-shadow samples per spherical-light shading")
    p.add_argument("--soft-shadow-kernel", default="auto", choices=["auto", "on", "off"],
                   help="spherical-light samplers as kernels ('auto' = on the card; 'on' on "
                        "the CPU runs their plain twins, 'off' the scan over the any-hit "
                        "oracle)")
    p.add_argument("--aa", action="store_true", help="2x2 supersampling")
    p.add_argument("--bloom", action="store_true")
    p.add_argument("--motion-blur", action="store_true")
    p.add_argument("--reference-quirks", action="store_true",
                   help="reproduce documented reference bugs for pixel parity")
    p.add_argument("--seed", type=int, default=0, help="seed of the torch.Generator")
    # Camera (defaults = reference main.cpp:730-731).
    p.add_argument("--look-at", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--euler-deg", type=float, nargs=3, default=[20.0, 20.0, 0.0])
    p.add_argument("--dist", type=float, default=3.0)
    p.add_argument("--fovy-deg", type=float, default=50.0)
    # Light editor (the ImGui panel, main.cpp:812-876): point lights first,
    # then spherical; removes apply first, then adds, then the edit.
    p.add_argument("--light-index", type=int, default=0)
    p.add_argument("--light-pos", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--light-color", type=float, nargs=3, default=None,
                   metavar=("R", "G", "B"))
    p.add_argument("--light-radius", type=float, default=None)
    p.add_argument("--add-point-light", type=float, nargs=6, action="append", default=None,
                   metavar=("X", "Y", "Z", "R", "G", "B"))
    p.add_argument("--add-spherical-light", type=float, nargs=7, action="append",
                   default=None, metavar=("X", "Y", "Z", "RADIUS", "R", "G", "B"))
    p.add_argument("--remove-light", type=int, action="append", default=None,
                   metavar="INDEX")


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is False "
                           f"(pass --device cpu to render on the CPU)")
    return device


def _build(args):
    import torch

    from .scene.lights import apply_edits
    from .scene.presets import STANDIN_NAMES, load_scene, load_standin
    from .scene.types import Camera
    from .utils.config import RenderConfig

    device = _device(args.device)
    scene = (load_standin(args.scene, device=device) if args.scene in STANDIN_NAMES
             else load_scene(args.scene, data_dir=args.data_dir, device=device))
    scene = apply_edits(scene, removes=args.remove_light or (),
                        add_points=args.add_point_light or (),
                        add_sphericals=args.add_spherical_light or (),
                        index=args.light_index, position=args.light_pos,
                        color=args.light_color, radius=args.light_radius)
    camera = Camera.default(look_at=args.look_at, euler_deg=args.euler_deg, dist=args.dist,
                            fovy_deg=args.fovy_deg, aspect=args.width / args.height,
                            device=device)
    cfg = RenderConfig(width=args.width, height=args.height, max_depth=args.max_bounces,
                       anti_aliasing=args.aa, bloom=args.bloom, motion_blur=args.motion_blur,
                       backend=args.backend, reference_quirks=args.reference_quirks,
                       soft_shadow_samples=args.spp, soft_shadow_kernel=args.soft_shadow_kernel)
    # A CPU generator: each render draws its sample key on the host.
    generator = torch.Generator().manual_seed(args.seed)
    return scene, camera, cfg, generator


def cmd_render(args) -> int:
    import torch

    from .models.whitted import render
    from .utils.image import write_bmp, write_png
    from .utils.profiling import profiler_trace

    scene, camera, cfg, generator = _build(args)
    # A CLI render never differentiates: allow the forward-only trace kernel.
    cfg = dataclasses.replace(cfg, forward_only=True)
    sync = torch.cuda.synchronize if scene.device.type == "cuda" else (lambda: None)
    img = render(scene, camera, cfg, generator=generator)
    sync()
    with profiler_trace(args.profile):
        t0 = time.perf_counter()
        img = render(scene, camera, cfg, generator=generator)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    print(f"Time to render image: {ms:.2f} milliseconds")
    print(f"{cfg.width * cfg.height / (ms / 1e3):.3e} primary rays/s")
    if args.output.lower().endswith(".bmp"):
        write_bmp(args.output, img)
    else:
        write_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_optimize(args) -> int:
    from .models.whitted import render
    from .optim.inverse import apply_material_params, optimize
    from .utils.image import read_image, write_png

    scene, camera, cfg, generator = _build(args)
    target = read_image(args.target)
    if target.shape[:2] != (cfg.height, cfg.width):
        print(f"error: target is {target.shape[1]}x{target.shape[0]}, "
              f"render is {cfg.width}x{cfg.height}", file=sys.stderr)
        return 2
    params, losses = optimize(scene, camera, target, cfg, steps=args.steps,
                              learning_rate=args.lr, checkpoint_path=args.checkpoint,
                              key=generator)
    if losses:
        print(f"final loss: {losses[-1]:.6e}")
    if args.output:
        img = render(apply_material_params(scene, params), camera, cfg, generator=generator)
        write_png(args.output, img)
        print(f"wrote {args.output}")
    return 0


def cmd_bench(args) -> int:
    import json

    from .utils.bench import run_bench

    result = run_bench(scene=args.scene, width=args.width, height=args.height,
                       backend=args.backend, data_dir=args.data_dir, device=args.device)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    from .scene.presets import SCENE_NAMES

    parser = argparse.ArgumentParser(prog="cgrt-torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_render = sub.add_parser("render", help="render a scene to an image file")
    _add_common(p_render)
    p_render.add_argument("--output", "-o", default="render.png")
    p_render.add_argument("--profile", default=None, metavar="DIR",
                          help="write a torch.profiler Chrome trace of the timed render into DIR")
    p_render.set_defaults(fn=cmd_render)
    p_opt = sub.add_parser("optimize", help="inverse rendering against a target image")
    _add_common(p_opt)
    p_opt.add_argument("--target", required=True, help="target image path")
    p_opt.add_argument("--steps", type=int, default=100)
    p_opt.add_argument("--lr", type=float, default=1e-2)
    p_opt.add_argument("--checkpoint", default=None, help="npz checkpoint (resumed if present)")
    p_opt.add_argument("--output", "-o", default=None, help="render the optimised scene here")
    p_opt.set_defaults(fn=cmd_optimize)
    p_bench = sub.add_parser("bench", help="forward throughput on the card (one JSON line)")
    _add_common(p_bench)
    p_bench.set_defaults(fn=cmd_bench)
    p_list = sub.add_parser("list-scenes", help="list preset scenes")
    p_list.set_defaults(fn=lambda a: (print("\n".join(SCENE_NAMES)), 0)[1])
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
