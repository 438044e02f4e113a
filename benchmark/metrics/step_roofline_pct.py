"""step_roofline_pct: the least time of one training step of a
brute-force scene (the closed form of ``rtbench/yard.py::headline_roofline``:
every ray tests every triangle at each bounce, a shadow ray per light, the
surface and Phong, the backward at twice their forward) over the window's
step time: the whole step's share of the card's peak (entry layer)."""

from rtbench import yard


def read(ctx):
    if ctx.kind != "train":
        return None
    run = ctx.run
    tris = sum(len(m["triangles"]) for m in run.meshes)
    lights = len(run.config.get("point_lights", []))
    least = yard.headline_roofline(run.width, run.height, tris, lights,
                                   int(run.config["max_depth"]), True)["seconds"]
    return 100.0 * least / (ctx.e2e["step_ms"] / 1e3)
