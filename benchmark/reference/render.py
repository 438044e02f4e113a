"""A plain Whitted ray tracer in PyTorch: the reference that decides whether
what the program rendered is right.

The semantics are upstream's (mgokbulut/CG-RayTracer), as the program
documents them:

- camera (trackball.cpp:70-103): position = lookAt + quat(euler) (0, 0,
  -dist); the camera-space direction normalize(-x halfW, y halfH, 1) at the
  pixel corner, x = (col + ox) / W * 2 - 1, y = (H - 1 - row + oy) / H * 2 - 1;
- triangles (ray_tracing.cpp:94-106): double-sided Moller-Trumbore, |det| >
  1e-9, barycentrics inclusive by 1e-6, t >= 0; the closest hit by strict
  ``<`` with the lowest index winning ties; the shading normal the
  barycentric blend of the vertex normals, normalised and turned toward
  the viewer by the face normal;
- Phong toward each light (main.cpp:61-135), the reflected view direction
  raised to the shininess, zero where its cosine is not positive; a point
  light's shadow ray starts 1e-3 along the light direction and is blocked
  by a hit at t < distance - 1e-3;
- a spherical light (main.cpp:166-218) shades as a point light at its
  centre, scaled by the fraction of ``samples`` shadow rays toward points
  on its sphere (``philox.gaussians`` normalised) that reach it; each ray
  starts 1e-3 along its direction and is blocked by a hit at t in [0,
  distance from that origin);
- bounces (main.cpp:244-267): the colour adds throughput x direct light
  where the ray is live and hit; the throughput takes ks; a ray goes on
  where any ks channel exceeds 0.01 (only ks.z under the reference's
  quirks); the reflected ray leaves 1e-3 along reflect(d, n); depth 2.

Everything is float32 unless a caller asks for another type (the
precision control).  Hits are searched without gradient; the surface at
the hit is worked out again differentiably, so ``train.py`` takes its
gradients through this file.  The soft-shadow search culls, for each
shading point, the triangles whose bounding sphere misses the capsule of
the light's radius around the segment to the light's centre: every sample
ray lies inside that capsule, so the counts are those of a search over
every triangle.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import blur, philox

DET_EPS = 1e-9
BARY_EPS = 1e-6
SHADOW_EPS = 1e-3
REFLECT_EPS = 1e-3
TINY = 1e-20
REFLECT_KS = 0.01
AA_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5))
RAYS_PER_CHUNK = 1 << 15  # rays x triangles per closest-hit step: 2**15 x 2048
TRI_CHUNK = 2048
PAIRS_PER_CHUNK = 1 << 15  # (point, triangle) pairs per soft-shadow step, x samples


@dataclasses.dataclass
class Scene:
    vertices: torch.Tensor  # [V, 3]
    normals: torch.Tensor  # [V, 3]
    triangles: torch.Tensor  # [T, 3] int64
    tri_material: torch.Tensor  # [T] int64
    kd: torch.Tensor  # [M, 3]
    ks: torch.Tensor  # [M, 3]
    shininess: torch.Tensor  # [M]
    pl_position: torch.Tensor  # [L, 3]
    pl_color: torch.Tensor  # [L, 3]
    sl_position: torch.Tensor  # [Ls, 3]
    sl_radius: torch.Tensor  # [Ls]
    sl_color: torch.Tensor  # [Ls, 3]


def make_scene(meshes, point_lights=(), spherical_lights=(), device="cpu",
               dtype=torch.float32) -> Scene:
    """The meshes (dicts of numpy arrays and a material) concatenated in
    order, one material row per mesh; ``point_lights`` ((position, color),
    ...), ``spherical_lights`` ((position, radius, color), ...)."""
    verts, norms, tris, mats = [], [], [], []
    kd, ks, shin = [], [], []
    offset = 0
    for i, m in enumerate(meshes):
        v = np.asarray(m["vertices"], np.float32)
        t = np.asarray(m["triangles"], np.int64)
        verts.append(v)
        norms.append(np.asarray(m["normals"], np.float32))
        tris.append(t + offset)
        mats.append(np.full((t.shape[0],), i, np.int64))
        mat = m["material"]
        kd.append(mat.get("kd", (1.0, 1.0, 1.0)))
        ks.append(mat.get("ks", (0.0, 0.0, 0.0)))
        shin.append(mat.get("shininess", 1.0))
        offset += v.shape[0]

    def f(x, shape):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(shape), device=device).to(dtype)

    return Scene(
        vertices=f(np.concatenate(verts), (-1, 3)), normals=f(np.concatenate(norms), (-1, 3)),
        triangles=torch.as_tensor(np.concatenate(tris), device=device),
        tri_material=torch.as_tensor(np.concatenate(mats), device=device),
        kd=f(kd, (-1, 3)), ks=f(ks, (-1, 3)), shininess=f(shin, (-1,)),
        pl_position=f([p for p, _ in point_lights], (-1, 3)),
        pl_color=f([c for _, c in point_lights], (-1, 3)),
        sl_position=f([p for p, _, _ in spherical_lights], (-1, 3)),
        sl_radius=f([r for _, r, _ in spherical_lights], (-1,)),
        sl_color=f([c for _, _, c in spherical_lights], (-1, 3)))


def with_dtype(scene: Scene, dtype) -> Scene:
    return dataclasses.replace(scene, **{
        f.name: (v.to(dtype) if v.is_floating_point() else v)
        for f in dataclasses.fields(scene) for v in (getattr(scene, f.name),)})


# --------------------------------------------------------------------------
# Vectors, camera.
# --------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def unit(a):
    """a / max(|a|, 1e-20)."""
    return a / torch.clamp_min(torch.sqrt(dot(a, a)), TINY)[..., None]


def reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def quat(euler):
    """glm::quat of Euler angles -> (w, x, y, z)."""
    c, s = torch.cos(euler * 0.5), torch.sin(euler * 0.5)
    cx, cy, cz, sx, sy, sz = c[0], c[1], c[2], s[0], s[1], s[2]
    return torch.stack([cx * cy * cz + sx * sy * sz, sx * cy * cz - cx * sy * sz,
                        cx * sy * cz + sx * cy * sz, cx * cy * sz - sx * sy * cz])


def rotate(q, v):
    u = q[1:]
    return v + 2.0 * cross(u, cross(u, v) + q[0] * v)


def camera_rays(camera: dict, width: int, height: int, pixels, offset=(0.0, 0.0),
                dtype=torch.float32):
    """Primary rays of the pixels with raster indices ``pixels`` (int64
    [N]) -> (origins [N, 3], dirs [N, 3]).  ``camera``: tensors
    ``look_at`` [3], ``euler`` [3] (radians), ``dist``, ``fovy`` (radians),
    ``aspect``."""
    cam = {k: v.to(dtype) for k, v in camera.items()}
    cols, rows = pixels % width, pixels // width
    x = (cols.to(dtype) + offset[0]) / width * 2.0 - 1.0
    y = ((height - 1 - rows).to(dtype) + offset[1]) / height * 2.0 - 1.0
    half_h = torch.tan(cam["fovy"] / 2.0)
    half_w = cam["aspect"] * half_h
    local = torch.stack([-x * half_w, y * half_h, torch.ones_like(x)], dim=-1)
    local = local / torch.sqrt(dot(local, local))[..., None]
    q = quat(cam["euler"])
    d = rotate(q, local)
    zero = torch.zeros_like(cam["dist"])
    o = cam["look_at"] + rotate(q, torch.stack([zero, zero, -cam["dist"]]))
    return o.expand_as(d).contiguous(), d


# --------------------------------------------------------------------------
# Triangles.
# --------------------------------------------------------------------------

def mt(o, d, v0, e1, e2):
    """Moller-Trumbore on broadcast operands -> (t, u, v, hit)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    hit = ok & (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS) & (t >= 0.0)
    return t, u, v, hit


def tri_table(scene: Scene):
    """(v0, e1, e2) [T, 3] of every triangle, detached."""
    v = scene.vertices.detach()
    tri = scene.triangles
    v0, v1, v2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    return v0, v1 - v0, v2 - v0


@torch.no_grad()
def closest(table, o, d, live=None):
    """Closest triangle per ray -> prim [N] int64 (-1: a miss, or not live)."""
    v0, e1, e2 = table
    n = o.shape[0]
    prim = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    rows = torch.arange(n, device=o.device) if live is None else torch.nonzero(live)[:, 0]
    inf = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
    step = max(1, (RAYS_PER_CHUNK * TRI_CHUNK) // max(1, v0.shape[0]))
    for r0 in range(0, rows.numel(), step):
        r = rows[r0:r0 + step]
        oc, dc = o[r, None, :], d[r, None, :]
        best = torch.full((r.numel(),), float("inf"), dtype=o.dtype, device=o.device)
        arg = torch.full((r.numel(),), -1, dtype=torch.int64, device=o.device)
        for s in range(0, v0.shape[0], TRI_CHUNK):
            t, _, _, hit = mt(oc, dc, v0[None, s:s + TRI_CHUNK], e1[None, s:s + TRI_CHUNK],
                              e2[None, s:s + TRI_CHUNK])
            t = torch.where(hit, t, inf)
            j = torch.argmin(t, dim=1)
            tj = t.gather(1, j[:, None])[:, 0]
            closer = tj < best
            best = torch.where(closer, tj, best)
            arg = torch.where(closer, j + s, arg)
        prim[r] = arg
    return prim


@torch.no_grad()
def blocked(table, o, d, t_max):
    """True where some triangle lies at t in [0, t_max)."""
    v0, e1, e2 = table
    out = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    step = max(1, (RAYS_PER_CHUNK * TRI_CHUNK) // max(1, v0.shape[0]))
    for r0 in range(0, o.shape[0], step):
        oc, dc, tc = o[r0:r0 + step, None], d[r0:r0 + step, None], t_max[r0:r0 + step, None]
        acc = torch.zeros((oc.shape[0],), dtype=torch.bool, device=o.device)
        for s in range(0, v0.shape[0], TRI_CHUNK):
            t, _, _, hit = mt(oc, dc, v0[None, s:s + TRI_CHUNK], e1[None, s:s + TRI_CHUNK],
                              e2[None, s:s + TRI_CHUNK])
            acc = acc | (hit & (t < tc)).any(dim=1)
        out[r0:r0 + step] = acc
    return out


class Surface:
    def __init__(self, valid, position, normal, kd, ks, shininess):
        self.valid, self.position, self.normal = valid, position, normal
        self.kd, self.ks, self.shininess = kd, ks, shininess


def surface(scene: Scene, o, d, prim) -> Surface:
    """The surface at each hit, differentiable in the scene and the rays:
    Moller-Trumbore solved again on the hit triangle, the blended normal
    turned toward the viewer, the material row.  Rays that missed get
    zeros (shininess 1)."""
    valid = prim >= 0
    rows = torch.nonzero(valid)[:, 0]
    n = prim.shape[0]
    p = prim[rows]
    tri = scene.triangles[p]
    vv, nn = scene.vertices, scene.normals
    v0, v1, v2 = vv[tri[:, 0]], vv[tri[:, 1]], vv[tri[:, 2]]
    n0, n1, n2 = nn[tri[:, 0]], nn[tri[:, 1]], nn[tri[:, 2]]
    oh, dh = o[rows], d[rows]
    e1, e2 = v1 - v0, v2 - v0
    t, u, v, _ = mt(oh, dh, v0, e1, e2)
    w0 = 1.0 - u - v
    normal = unit(w0[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2)
    face = unit(cross(e1, e2))
    facing = dot(face, -dh) > 0.0
    normal = torch.where(facing[:, None], normal, -normal)
    position = oh + dh * t[:, None]
    mat = scene.tri_material[p]

    def scatter(x, fill=0.0):
        out = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return out.index_put((rows,), x)

    return Surface(valid, scatter(position), scatter(normal), scatter(scene.kd[mat]),
                   scatter(scene.ks[mat]), scatter(scene.shininess[mat], 1.0))


# --------------------------------------------------------------------------
# Lights.
# --------------------------------------------------------------------------

def phong(d, surf: Surface, light_dir, light_color):
    diffuse = light_color * surf.kd * torch.clamp_min(dot(light_dir, surf.normal), 0.0)[:, None]
    cos = dot(unit(reflect(d, surf.normal)), light_dir)
    spec = torch.pow(torch.clamp_min(cos, 1e-30), surf.shininess)
    specular = light_color * surf.ks * torch.where(cos > 0.0, spec, torch.zeros_like(spec))[:, None]
    return diffuse + specular


def point_light_hidden(table, position, valid, light_pos):
    """[N] bool: the point light is blocked from the surface point."""
    to = light_pos - position
    ldir = unit(to)
    origin = position + SHADOW_EPS * ldir
    t_max = torch.sqrt(dot(to, to)) - SHADOW_EPS
    t_max = torch.where(valid, t_max, torch.full_like(t_max, -1.0))
    return blocked(table, origin.detach(), ldir.detach(), t_max.detach())


def sample_rays(p, g, light):
    """Shadow rays from ``p`` [..., 3] toward the sphere points of the
    Gaussians ``g`` [..., 3] -> (origins, dirs, t_max)."""
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    inv = 1.0 / torch.clamp_min(torch.sqrt(gx * gx + gy * gy + gz * gz), TINY)
    sx = light[0] + light[3] * (gx * inv)
    sy = light[1] + light[3] * (gy * inv)
    sz = light[2] + light[3] * (gz * inv)
    tx, ty, tz = sx - p[..., 0], sy - p[..., 1], sz - p[..., 2]
    invd = 1.0 / torch.clamp_min(torch.sqrt(tx * tx + ty * ty + tz * tz), TINY)
    dx, dy, dz = tx * invd, ty * invd, tz * invd
    ox = p[..., 0] + SHADOW_EPS * dx
    oy = p[..., 1] + SHADOW_EPS * dy
    oz = p[..., 2] + SHADOW_EPS * dz
    ex, ey, ez = sx - ox, sy - oy, sz - oz
    tm = torch.sqrt(ex * ex + ey * ey + ez * ez)
    return torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1), tm


@torch.no_grad()
def candidates(bounds, p, center, radius):
    """(point, triangle) pairs [M] whose triangle's bounding sphere meets
    the capsule of ``radius`` around the segment from each point ``p``
    [P, 3] to ``center`` (float32, with room for rounding)."""
    tc, tr = bounds
    p32, c32 = p.float(), center.float()
    seg = c32 - p32  # [P, 3]
    seg2 = torch.clamp_min(dot(seg, seg), TINY)
    reach = float(radius) + 2e-3
    out_p, out_t = [], []
    step = max(1, (1 << 24) // max(1, tc.shape[0]))
    for s in range(0, p32.shape[0], step):
        rel = tc[None] - p32[s:s + step, None]  # [P', T, 3]
        a = torch.clamp(dot(rel, seg[s:s + step, None]) / seg2[s:s + step, None], 0.0, 1.0)
        gap = rel - a[..., None] * seg[s:s + step, None]
        near = torch.sqrt(dot(gap, gap)) <= reach + tr[None]
        pi, ti = torch.nonzero(near, as_tuple=True)
        out_p.append(pi + s)
        out_t.append(ti)
    return torch.cat(out_p), torch.cat(out_t)


def tri_bounds(table):
    """Centroids and bounding radii [T] of the triangles (float32)."""
    v0, e1, e2 = (x.float() for x in table)
    c = v0 + (e1 + e2) / 3.0
    r = torch.stack([torch.sqrt(dot(q, q)) for q in (v0 - c, v0 + e1 - c, v0 + e2 - c)]).amax(0)
    return c, r * 1.0001 + 1e-6


@torch.no_grad()
def visible_counts(table, bounds, position, g, light_row, key: tuple, samples: int):
    """Per point, how many of ``samples`` rays toward the spherical light
    reach it; ``g``: the points' raster indices, the stream's counter."""
    n = position.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=position.dtype, device=position.device)
    gauss = philox.gaussians(g, torch.arange(samples, device=g.device), key, position.dtype)
    o, d, t_max = sample_rays(position[:, None, :], gauss, light_row)  # [P, S, ...]
    hits = torch.zeros((n, samples), dtype=torch.int32, device=position.device)
    pi, ti = candidates(bounds, position, light_row[:3], light_row[3])
    v0, e1, e2 = table
    step = max(1, PAIRS_PER_CHUNK * 200 // samples)
    for s in range(0, pi.numel(), step):
        a, b = pi[s:s + step], ti[s:s + step]
        t, _, _, hit = mt(o[a], d[a], v0[b, None], e1[b, None], e2[b, None])
        hits.index_add_(0, a, (hit & (t < t_max[a])).to(torch.int32))
    return (hits == 0).sum(dim=1).to(position.dtype)


# --------------------------------------------------------------------------
# The trace.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Frame:
    """What a frame is rendered with: its size, depth, effects and samples."""

    width: int
    height: int
    max_depth: int = 2
    quirks: bool = False
    anti_aliasing: bool = False
    bloom: bool = False
    samples: int = 200


def trace(scene: Scene, o, d, g, frame: Frame, key=None, table=None, bounds=None,
          prims=None):
    """Colours [N, 3] of the rays (o, d) whose pixels have raster indices
    ``g``.  ``key``: the frame's sample key (spherical lights).  ``prims``:
    a list that gets each level's hit ids and live mask."""
    dtype = o.dtype
    table = tri_table(scene) if table is None else table
    if bounds is None and scene.sl_position.shape[0] > 0:
        bounds = tri_bounds(table)
    n = o.shape[0]
    color = torch.zeros((n, 3), dtype=dtype, device=o.device)
    throughput = torch.ones((n, 3), dtype=dtype, device=o.device)
    active = torch.ones((n,), dtype=torch.bool, device=o.device)
    for level in range(frame.max_depth):
        prim = closest(table, o.detach(), d.detach(), None if level == 0 else active)
        if prims is not None:
            prims.append((prim, active.clone()))
        surf = surface(scene, o, d, prim)
        direct = torch.zeros_like(surf.position)
        for li in range(scene.pl_position.shape[0]):
            lpos = scene.pl_position[li]
            hidden = point_light_hidden(table, surf.position.detach(), surf.valid, lpos.detach())
            lit = (~hidden) & surf.valid
            direct = direct + phong(d, surf, unit(lpos - surf.position),
                                    scene.pl_color[li]) * lit[:, None].to(dtype)
        soft = torch.zeros_like(surf.position)
        for li in range(scene.sl_position.shape[0]):
            lkey = philox.fold_in(philox.fold_in(key, level), li)
            row = torch.cat([scene.sl_position[li].detach(), scene.sl_radius[li:li + 1].detach()])
            rows = torch.nonzero(surf.valid)[:, 0]
            counts = visible_counts(table, bounds, surf.position.detach()[rows], g[rows], row,
                                    lkey, frame.samples)
            frac = torch.zeros((n,), dtype=dtype, device=o.device).index_put(
                (rows,), counts / float(frame.samples))
            w = frac * surf.valid.to(dtype)
            soft = soft + phong(d, surf, unit(scene.sl_position[li] - surf.position),
                                scene.sl_color[li]) * w[:, None]
        direct = direct + soft
        lit = active & surf.valid
        color = color + throughput * direct * lit[:, None].to(dtype)
        if level + 1 >= frame.max_depth:
            break
        if frame.quirks:
            reflective = surf.ks[:, 2] > REFLECT_KS
        else:
            reflective = (surf.ks > REFLECT_KS).any(dim=1)
        active = lit & reflective
        throughput = throughput * surf.ks
        rdir = unit(reflect(d, surf.normal))
        o = surf.position + REFLECT_EPS * rdir
        d = torch.where(active[:, None], rdir, d)
    return color


def depth_for(scene: Scene, frame: Frame) -> Frame:
    """Depth 1 where no material passes the reflection test (every later
    level adds zero)."""
    ks = scene.ks.detach()
    test = ks[:, 2] > REFLECT_KS if frame.quirks else (ks > REFLECT_KS).any(dim=1)
    if bool(test.any()):
        return frame
    return dataclasses.replace(frame, max_depth=min(frame.max_depth, 1))


def render_pixels(scene: Scene, camera: dict, frame: Frame, pixels, key=None,
                  offset=(0.0, 0.0), dtype=torch.float32, prims=None):
    """Colours [N, 3] of the pixels with raster indices ``pixels``."""
    o, d = camera_rays(camera, frame.width, frame.height, pixels, offset, dtype)
    return trace(scene, o, d, pixels, depth_for(scene, frame), key, prims=prims)


def render_frame(scene: Scene, camera: dict, frame: Frame, key=None, pixels=None,
                 dtype=torch.float32):
    """The frame [H, W, 3] (or the colours [N, 3] of ``pixels``, without
    bloom), with the effects ``frame`` asks for: 2 x 2 supersampling (over 5
    under the quirks), and under the quirks with anti-aliasing the
    reference's bloom, the in-place blur of the last subsample where the
    subsamples' sum passes the threshold, added to the first subsample
    (main.cpp:663-705)."""
    every = pixels is None
    if every:
        pixels = torch.arange(frame.width * frame.height, device=camera["euler"].device)
    if frame.bloom and not every:
        raise ValueError("bloom blurs the whole frame: render every pixel")
    if frame.bloom and not (frame.quirks and frame.anti_aliasing):
        raise NotImplementedError("the reference renders bloom only on the quirks' AA path")
    if frame.anti_aliasing:
        subs = [render_pixels(scene, camera, frame, pixels, key, off, dtype)
                for off in AA_OFFSETS]
        if frame.bloom:
            total = subs[0] + subs[1] + subs[2] + subs[3]
            bright = torch.where(total.sum(dim=-1, keepdim=True) > 1.0, subs[3],
                                 torch.zeros_like(subs[3]))
            img = subs[0].reshape(frame.height, frame.width, 3)
            return img + blur.quirk_blur(bright.reshape(frame.height, frame.width, 3))
        out = (subs[0] + subs[1] + subs[2] + subs[3]) / (5.0 if frame.quirks else 4.0)
    else:
        out = render_pixels(scene, camera, frame, pixels, key, (0.0, 0.0), dtype)
    return out.reshape(frame.height, frame.width, 3) if every else out


def camera_dict(look_at, euler, dist, fovy, aspect, device, dtype=torch.float32) -> dict:
    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return {"look_at": f(look_at), "euler": f(euler), "dist": f(dist), "fovy": f(fovy),
            "aspect": f(aspect)}


def radians32(deg) -> np.ndarray:
    """Degrees to radians in float64, rounded once to float32."""
    return np.radians(np.asarray(deg, np.float64)).astype(np.float32)


@torch.no_grad()
def level_hits(scene: Scene, o, d, frame: Frame) -> list:
    """Each bounce level's hit ids [N] (-1: a miss, or a ray no longer
    live) and the live mask it was traced under, without lighting."""
    frame = depth_for(scene, frame)
    table = tri_table(scene)
    active = torch.ones((o.shape[0],), dtype=torch.bool, device=o.device)
    out = []
    for level in range(frame.max_depth):
        prim = closest(table, o, d, None if level == 0 else active)
        out.append((prim, active.clone()))
        if level + 1 >= frame.max_depth:
            break
        surf = surface(scene, o, d, prim)
        if frame.quirks:
            reflective = surf.ks[:, 2] > REFLECT_KS
        else:
            reflective = (surf.ks > REFLECT_KS).any(dim=1)
        active = active & surf.valid & reflective
        rdir = unit(reflect(d, surf.normal))
        o = surf.position + REFLECT_EPS * rdir
        d = torch.where(active[:, None], rdir, d)
    return out
