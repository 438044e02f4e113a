"""Inverse rendering in plain PyTorch: the reference for the program's
``optimize()``.

The loss is mean((render(scene <- params) - target)^2) over the frame;
the gradient is autograd's through ``render.py``, whose hit search takes
no gradient: the gradients of the one-phase trace that the program's
two-phase structure claims.  The update is Adam (Kingma and Ba, with
PyTorch's bias-corrected form): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2)
g^2, p -= lr / (1 - b1^t) m / (sqrt(v) / sqrt(1 - b2^t) + eps).
"""
from __future__ import annotations

import dataclasses

import torch

from . import render

BETAS = (0.9, 0.999)
EPS = 1e-8
PARAMS = ("kd", "ks", "shininess", "light_color", "light_position", "vertices")


def params_of(scene: render.Scene) -> dict:
    return {"kd": scene.kd, "ks": scene.ks, "shininess": scene.shininess,
            "light_color": scene.pl_color, "light_position": scene.pl_position,
            "vertices": scene.vertices}


def apply(scene: render.Scene, params: dict) -> render.Scene:
    return dataclasses.replace(scene, kd=params["kd"], ks=params["ks"],
                               shininess=params["shininess"], pl_color=params["light_color"],
                               pl_position=params["light_position"],
                               vertices=params["vertices"])


def image(scene, camera, frame, dtype):
    pixels = torch.arange(frame.width * frame.height, device=scene.vertices.device)
    return render.render_pixels(scene, camera, frame, pixels, dtype=dtype)


def fit(scene: render.Scene, target_scene: render.Scene, camera: dict, frame: render.Frame,
        steps: int = 3, lr: float = 1e-2, dtype=torch.float32, at: int = 0,
        fault=None, state=None) -> dict:
    """``steps`` Adam steps toward the frame of ``target_scene``, and the
    loss after them -> {'losses': [steps + 1], 'grad': the first step's
    gradient by leaf; after step ``at`` (default: the last) 'change': each
    leaf's change, 'moment': Adam's first moment, bias-corrected, and
    'state': the parameters and Adam's state}.  The steps start from
    ``scene``'s parameters and a fresh Adam, or from ``state`` ({'params',
    'm', 'v': by leaf, 't': the steps taken}) where given.  ``fault(step,
    image, target) -> (image, target)``, where given, stands between the
    render and the loss (``step`` counts from the fit's start): the check's
    planted faults."""
    scene = render.with_dtype(scene, dtype)
    camera = {k: v.to(dtype) for k, v in camera.items()}
    with torch.no_grad():
        target = image(render.with_dtype(target_scene, dtype), camera, frame, dtype)
    if state is None:
        start = {k: v.detach().clone() for k, v in params_of(scene).items()}
        m = {k: torch.zeros_like(v) for k, v in start.items()}
        v2 = {k: torch.zeros_like(v) for k, v in start.items()}
        t0 = 0
    else:
        cast = {k: v.to(dtype) for k, v in params_of(scene).items()}
        start = {k: torch.as_tensor(state["params"][k]).to(cast[k]) for k in PARAMS}
        m = {k: torch.as_tensor(state["m"][k]).to(cast[k]).clone() for k in PARAMS}
        v2 = {k: torch.as_tensor(state["v"][k]).to(cast[k]).clone() for k in PARAMS}
        t0 = int(state["t"])
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    at = at or steps
    out = {"losses": [], "grad": None, "change": None, "moment": None, "state": None}
    for step in range(steps + 1):
        img, tgt = image(apply(scene, params), camera, frame, dtype), target
        if fault is not None:
            img, tgt = fault(t0 + step, img, tgt)
        loss = torch.mean((img - tgt) ** 2)
        out["losses"].append(float(loss.detach()))
        if step == steps:
            break
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(params, grads)}
        if out["grad"] is None:
            out["grad"] = {k: g.detach().float() for k, g in grads.items()}
        t = t0 + step + 1
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                c1, c2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
                denom = v2[k].sqrt() / (c2 ** 0.5) + EPS
                p.addcdiv_(m[k], denom, value=-lr / c1)
        if step + 1 == at:
            out["change"] = {k: (params[k].detach() - start[k]).float() for k in params}
            out["moment"] = {k: (m[k] / (1 - BETAS[0] ** t)).float() for k in params}
            out["state"] = {"params": {k: p.detach().float().clone() for k, p in params.items()},
                            "m": {k: x.float().clone() for k, x in m.items()},
                            "v": {k: x.float().clone() for k, x in v2.items()}, "t": t}
    return out
