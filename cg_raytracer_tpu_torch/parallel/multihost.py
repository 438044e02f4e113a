"""Process launch, the row split and tile-level failure recovery, as in
``cg_raytracer_tpu/parallel/multihost.py``, over ``torch.distributed``.

``initialize_distributed`` joins the process group that ``torchrun`` (or
the caller) describes: NCCL on the card, gloo on the CPU or where asked
(gloo lets two ranks share one card; NCCL refuses that).  A failed init
raises; nothing retries on another backend.  ``global_mesh`` is the 1-D
mesh over every rank.  Renders are pure functions of (scene, camera, rows),
so ``render_with_recovery`` re-runs a failed row tile anywhere.

``spawn`` starts a world of local processes (``torch.multiprocessing``,
spawn start method, a free localhost port) and raises if any rank fails.

Run as a module under ``torchrun`` it renders a preset sharded over the
world's ranks and writes the PNG from rank 0::

    torchrun --nproc-per-node 1 -m cg_raytracer_tpu_torch.parallel.multihost \\
        --scene teacup --width 1024 --height 1024 -o teacup.png
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .sharding import RAY_AXIS, make_mesh, rank_device, row_block, world


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           device=None, backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> Optional[str]:
    """Join the process group; returns the backend, or None (nothing done)
    when no address is given and ``MASTER_ADDR`` is unset (a single-process
    run) or the group exists already.

    ``init_method`` (default ``tcp://MASTER_ADDR:MASTER_PORT``),
    ``world_size`` (``WORLD_SIZE``) and ``rank`` (``RANK``) are torchrun's
    variables unless given.  ``backend``: default 'nccl' when ``device``
    (default 'cuda') is a card, 'gloo' on the CPU.  On the card the rank's
    device is made current first (``sharding.rank_device``)."""
    if dist.is_initialized():
        return None
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            return None
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    dev = rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return backend


def global_mesh(axis: str = RAY_AXIS, device=None):
    """1-D mesh over every rank of the world."""
    return make_mesh(device=device, axis=axis)


def host_local_rows(height: int, rank_world: Optional[tuple] = None) -> slice:
    """The image rows a rank owns under row sharding, ceil(H / world) each
    (the last ones may be short or empty); ``rank_world`` = (rank, world
    size), default this process's."""
    rank, size = world() if rank_world is None else rank_world
    return slice(*row_block(height, rank, size))


def render_with_recovery(scene, camera, cfg, tile_rows: int = 64, max_retries: int = 2,
                         generator=None, accel=None, render_tile: Optional[Callable] = None,
                         log_fn: Optional[Callable] = None):
    """Row-tile render loop with re-run on failure: the frame as ceil(H /
    ``tile_rows``) tiles of ``render_rows`` (one backend and sample key for
    all), each re-rendered up to ``max_retries`` times before its error
    propagates.  ``render_tile(rows: slice) -> [k, W, 3]`` replaces the tile
    renderer (a test injects faults with it; a scheduler could route retries
    elsewhere).  Returns (image [H, W, 3] float32 numpy array, failures): a
    (rows, attempt, repr(error)) per failed attempt that was recovered."""
    from ..models.whitted import _frame_key, make_backend, render_rows

    if render_tile is None:
        backend = make_backend(scene, cfg, accel=accel)
        key = _frame_key(scene, generator)

        def render_tile(rows):
            return render_rows(scene, camera, cfg, rows, backend=backend, generator=key)

    img = np.zeros((cfg.height, cfg.width, 3), np.float32)
    failures = []
    for start in range(0, cfg.height, tile_rows):
        rows = slice(start, min(start + tile_rows, cfg.height))
        for attempt in range(max_retries + 1):
            try:
                tile = render_tile(rows)
                img[rows] = tile.detach().cpu().numpy() if torch.is_tensor(tile) else tile
                break
            except Exception as e:  # noqa: BLE001 - any tile failure retries
                failures.append((rows, attempt, repr(e)))
                if log_fn:
                    log_fn(f"tile rows {rows.start}:{rows.stop} failed "
                           f"(attempt {attempt + 1}/{max_retries + 1}): {e!r}")
                if attempt == max_retries:
                    raise
    return img, failures


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, nprocs, port, backend, device, args):
    initialize_distributed(f"tcp://127.0.0.1:{port}", nprocs, rank, device=device,
                           backend=backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), backend: str = "gloo",
          device="cpu") -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes joined in one
    process group (``backend`` on ``device``); raises if any rank fails
    (``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``).  ``fn`` must be importable by name."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned, args=(fn, nprocs, free_port(), backend, device, args),
                       nprocs=nprocs, join=True, start_method="spawn")


def main(argv=None) -> int:
    """A sharded render of a preset or stand-in under torchrun."""
    import argparse

    from ..scene.presets import STANDIN_NAMES, load_scene, load_standin
    from ..scene.types import Camera
    from ..utils.config import RenderConfig
    from ..utils.image import write_png
    from .sharding import sharded_render

    p = argparse.ArgumentParser(description="Sharded render over the ranks of a torchrun world.")
    p.add_argument("--scene", default="teacup", help="preset or stand-in (mirror_box, ...)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="'nccl' | 'gloo' (default: nccl on the card)")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("-o", "--output", default="sharded.png")
    args = p.parse_args(argv)
    initialize_distributed(device=args.device, backend=args.backend)
    try:
        mesh = global_mesh(device=args.device)
        load = load_standin if args.scene in STANDIN_NAMES else load_scene
        scene = load(args.scene, device=mesh.device)
        img = sharded_render(scene, Camera.default(device=mesh.device), RenderConfig(
            width=args.width, height=args.height), mesh)
        if mesh.rank == 0:
            write_png(args.output, img)
            print(f"{args.output}: {args.width}x{args.height} over {mesh.world} rank(s)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
