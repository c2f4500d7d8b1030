"""Plain reference renderer of the ShaderBall frame, written straight from
its definition with no tiles, bins, capacities or kernels:

1. vertex stage: world = Model·p, clip = ViewProj·world, normals through
   transpose(inverse(Model)) and normalized;
2. homogeneous triangle setup (edge functions of the 2D-homogeneous
   corners, no clipping: a triangle that crosses the near plane
   rasterizes its visible part), back faces and degenerates culled;
3. raster: every pixel of every triangle's bounding box tested at its
   centre; the nearest reversed-Z depth wins (the depth's float bits with
   the 3 lowest cleared, later triangles winning ties); perspective-correct
   barycentrics of the winner;
4. G-buffer: uv, world position, normal and the material's maps sampled
   bilinear with REPEAT addressing (u8 × 1/255), every attachment rounded
   through float16 (RGBA16F);
5. GGX lighting over the scene's lights (brdf.frag, with its quirks) plus
   the 0.03·albedo·ao ambient, the HDR result rounded through float16,
   the exposure tone map;
6. the light spheres (flat light colour, depth-tested against the scene)
   and the orientation gizmo (its own viewport, flat Lambert in view
   space) over the top-right corner;
7. the sRGB encode and u8 quantization.

Every floating-point step runs in ``dtype`` (float32 for the reference;
a lower precision for the control). Imports neither the program nor the
JAX package, and takes only the inputs the benchmark made: meshes, maps,
lights, frame parameters and camera poses.

The harness builds a configuration's reference through :func:`make`, the
one every reference module under ``reference/`` exposes, and plants the
faults of :data:`FAULTS` (configuration settings) in it; a configuration
without a ``"reference"`` key gets this module's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h100_bench.reference import scene as sc
from h100_bench.standin import writers
from h100_bench.standin.meshgen import (
    Mesh,
    generate_plane_mesh,
    generate_uv_sphere_mesh,
)

LOW3 = ~7  # clears the 3 low bits of a depth's float bits
PI = 3.1415926535897932384626433832795
INV255 = 1.0 / 255.0
# Candidates (triangle × pixel tests) per raster chunk.
CHUNK = 1 << 23


@dataclass
class FrameInputs:
    """What the benchmark hands the reference: the ball mesh (indexed,
    model units), the instance count, the bound material's maps
    (:func:`material_maps`), the lights (:func:`scene.shaderball_lights`),
    the gizmo mesh, and the frame's parameters."""

    ball: Mesh
    num_instances: int
    maps: dict
    lights: list
    gizmo: Mesh | None
    width: int
    height: int
    tone_map: bool = True
    exposure: float = 1.0
    show_lights: bool = True
    show_gizmo: bool = True
    gizmo_extent: int = 100
    angle: float = -90.0


# Maps of more texels than this are sampled with the weights blended in
# (w00, w01, w10, w11) order, smaller ones row by row: the two orders the
# program's samplers round in.
WEIGHTS_ORDER_TEXELS = 1 << 20
# The material maps the frame reads (normal mapping is off; the height
# map is bound but not read).
SAMPLED_MAPS = ("albedo", "metallic", "roughness", "ao")


def material_maps(root, index: int) -> dict:
    """The maps of material ``index`` of the resource root ``root``
    (materials in name order, ``default`` set apart), each map falling
    back to the default material's: kind → (H, W, C) uint8."""
    from pathlib import Path

    from PIL import Image

    pbr = Path(root) / "pbr"
    names = sorted(p.name for p in pbr.iterdir()
                   if p.is_dir() and p.name != "default")
    out = {}
    for kind in SAMPLED_MAPS:
        path = pbr / names[index] / f"{kind}.png"
        if not path.is_file():
            path = pbr / "default" / f"{kind}.png"
        img = np.asarray(Image.open(path))
        out[kind] = img[:, :, None] if img.ndim == 2 else img
    return out


# -- geometry ----------------------------------------------------------------

def _max3(t):
    return torch.maximum(torch.maximum(t[0], t[1]), t[2])


def _min3(t):
    return torch.minimum(torch.minimum(t[0], t[1]), t[2])


def setup(clip: tuple, width: int, height: int) -> dict:
    """Homogeneous setup of per-corner clip coordinates ((x0, x1, x2),
    (y..), (z..), (w..)): the scaled edge, z and w coefficients, the
    inclusive pixel bounding box and which triangles can cover a pixel."""
    x, y, z, w = clip
    xh = tuple((x[c] * 0.5 + w[c] * 0.5) * width for c in range(3))
    yh = tuple((y[c] * 0.5 + w[c] * 0.5) * height for c in range(3))
    w0, w1, w2 = w
    ea = (yh[1] * w2 - yh[2] * w1, yh[2] * w0 - yh[0] * w2,
          yh[0] * w1 - yh[1] * w0)
    eb = (xh[2] * w1 - xh[1] * w2, xh[0] * w2 - xh[2] * w0,
          xh[1] * w0 - xh[0] * w1)
    ec = (xh[1] * yh[2] - xh[2] * yh[1], xh[2] * yh[0] - xh[0] * yh[2],
          xh[0] * yh[1] - xh[1] * yh[0])
    det = ec[0] * w0 + ec[1] * w1 + ec[2] * w2
    valid = (det > 0.0) & (_max3(w) > 1e-6)
    zw_min = _min3((z[0] - w0, z[1] - w1, z[2] - w2))
    valid = valid & (_max3(z) >= 0.0) & (zw_min <= 0.0)

    def amax3(t):
        return torch.maximum(torch.maximum(t[0].abs(), t[1].abs()),
                             t[2].abs())

    max_abs = torch.maximum(amax3(ea), torch.maximum(amax3(eb), amax3(ec)))
    scale = 1.0 / torch.clamp(max_abs, min=1e-30)
    ea = tuple(e * scale for e in ea)
    eb = tuple(e * scale for e in eb)
    ec = tuple(e * scale for e in ec)

    def dot3c(e, t):
        return e[0] * t[0] + e[1] * t[1] + e[2] * t[2]

    w_ok = (w0 > 1e-6) & (w1 > 1e-6) & (w2 > 1e-6)
    inv_w = tuple(1.0 / torch.where(w[c] == 0, 1.0, w[c]) for c in range(3))
    xs = tuple(xh[c] * inv_w[c] for c in range(3))
    ys = tuple(yh[c] * inv_w[c] for c in range(3))
    bx0 = torch.where(w_ok, torch.floor(_min3(xs)), 0.0)
    bx1 = torch.where(w_ok, torch.ceil(_max3(xs)), float(width - 1))
    by0 = torch.where(w_ok, torch.floor(_min3(ys)), 0.0)
    by1 = torch.where(w_ok, torch.ceil(_max3(ys)), float(height - 1))
    valid = valid & (bx1 >= 0.0) & (bx0 < width) & (by1 >= 0.0) \
        & (by0 < height)

    def clip_i(b, hi):
        return torch.nan_to_num(torch.clamp(b.float(), 0, hi)).long()

    return dict(a=ea, b=eb, c=ec, z=(dot3c(ea, z), dot3c(eb, z),
                                     dot3c(ec, z)),
                w=(dot3c(ea, w), dot3c(eb, w), dot3c(ec, w)),
                bbox=(clip_i(bx0, width - 1), clip_i(by0, height - 1),
                      clip_i(bx1, width - 1), clip_i(by1, height - 1)),
                valid=valid)


def _plane(coef, idx, px, py):
    return coef[0][idx] * px + coef[1][idx] * py + coef[2][idx]


def candidates(s: dict):
    """Yield (triangle ids, pixel x, pixel y) of every pixel of every
    covering-capable triangle's bounding box, in chunks."""
    tri = torch.nonzero(s["valid"]).reshape(-1)
    if tri.numel() == 0:
        return
    bx0, by0, bx1, by1 = (b[tri] for b in s["bbox"])
    bw = bx1 - bx0 + 1
    area = bw * (by1 - by0 + 1)
    ends = torch.cumsum(area, 0)
    lo = 0
    while lo < tri.numel():
        # Triangles whose candidates fit one chunk (at least one).
        base = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, base + CHUNK, right=True))
        hi = max(hi, lo + 1)
        sel = slice(lo, hi)
        reps = area[sel]
        which = torch.repeat_interleave(
            torch.arange(hi - lo, device=tri.device), reps)
        start = torch.cumsum(reps, 0) - reps
        off = torch.arange(int(reps.sum()), device=tri.device) - start[which]
        w = bw[sel][which]
        yield (tri[sel][which], bx0[sel][which] + off % w,
               by0[sel][which] + off // w)
        lo = hi


def raster(s: dict, width: int, height: int):
    """Per pixel (H·W,) the winning triangle (-1: none) and its masked
    depth key (0: none). Coverage: every edge function >= 0, w > 0 and
    0 <= z <= w at the pixel centre; the largest (key, triangle id)
    wins."""
    dev = s["valid"].device
    best = torch.full((width * height,), -1, dtype=torch.int64, device=dev)
    for tri, px, py in candidates(s):
        fx = px.to(s["a"][0].dtype) + 0.5
        fy = py.to(s["a"][0].dtype) + 0.5
        e = [s["a"][k][tri] * fx + s["b"][k][tri] * fy + s["c"][k][tri]
             for k in range(3)]
        zn = _plane(s["z"], tri, fx, fy)
        wn = _plane(s["w"], tri, fx, fy)
        ok = ((e[0] >= 0.0) & (e[1] >= 0.0) & (e[2] >= 0.0) & (wn > 0.0)
              & (zn >= 0.0) & (zn <= wn))
        z = zn * (1.0 / torch.where(wn == 0.0, torch.ones_like(wn), wn))
        key = (z[ok].float().view(torch.int32) & LOW3).to(torch.int64)
        packed = (key << 32) | tri[ok]
        best.scatter_reduce_(0, (py * width + px)[ok], packed, "amax")
    hit = best >= 0
    tri = torch.where(hit, best & 0xFFFFFFFF, torch.full_like(best, -1))
    key = torch.where(hit, best >> 32, torch.zeros_like(best))
    return tri, key.to(torch.int32)


def pixel_centres(width: int, height: int, dev, dtype):
    pix = torch.arange(width * height, device=dev)
    return ((pix % width).to(dtype) + 0.5, (pix // width).to(dtype) + 0.5)


def resolve(s: dict, tri, corners: dict, width: int, height: int):
    """Perspective-correct attributes of each pixel's winner:
    ``corners`` maps a name to per-corner (T,) planes; misses read 0."""
    dt = s["a"][0].dtype
    px, py = pixel_centres(width, height, tri.device, dt)
    hit = tri >= 0
    idx = torch.clamp(tri, min=0)
    zero = torch.zeros((), dtype=dt, device=tri.device)

    def r(plane):
        return torch.where(hit, plane[idx], zero)

    e = [r(s["a"][k]) * px + r(s["b"][k]) * py + r(s["c"][k])
         for k in range(3)]
    esum = e[0] + e[1] + e[2]
    inv = 1.0 / torch.where(esum == 0.0, torch.ones_like(esum), esum)
    b = [torch.where(hit, e[k] * inv, zero) for k in range(3)]
    return {name: r(c[0]) * b[0] + r(c[1]) * b[1] + r(c[2]) * b[2]
            for name, c in corners.items()}


# -- shading -----------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize3(v):
    inv = 1.0 / torch.clamp(torch.sqrt(_dot3(v, v)), min=1e-20)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def bilinear(tex: torch.Tensor, u, v, order: str):
    """Bilinear REPEAT sample of an (H, W, C) u8 texture at (u, v), texel
    centres at +0.5, each tap × 1/255; ``order`` "weights" blends
    w00·t00 + w01·t01 + w10·t10 + w11·t11, "rows" the top and bottom rows
    first. Returns C planes."""
    h, w = tex.shape[0], tex.shape[1]
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = torch.remainder(x0.to(torch.int32), w).long()
    y0i = torch.remainder(y0.to(torch.int32), h).long()
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h
    dt = u.dtype

    def tap(yi, xi):
        return tex[yi, xi].to(dt) * INV255

    t00, t01, t10, t11 = tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i), \
        tap(y1i, x1i)
    out = []
    for c in range(tex.shape[2]):
        if order == "weights":
            val = (t00[:, c] * ((1.0 - tx) * (1.0 - ty))
                   + t01[:, c] * (tx * (1.0 - ty))
                   + t10[:, c] * ((1.0 - tx) * ty) + t11[:, c] * (tx * ty))
        else:
            top = t00[:, c] * (1.0 - tx) + t01[:, c] * tx
            bot = t10[:, c] * (1.0 - tx) + t11[:, c] * tx
            val = top * (1.0 - ty) + bot * ty
        out.append(val)
    return out


def q16(x: torch.Tensor) -> torch.Tensor:
    """RGBA16F attachment round trip."""
    return x.to(torch.float16).to(x.dtype)


def ggx(lights: dict, world, n, v, albedo, f0, met, rough,
        vis: dict | None = None):
    """brdf.frag's light loop → (r, g, b) outgoing radiance; ``vis`` maps
    a light index to a [0, 1] visibility plane that scales that light's
    radiance."""
    lo = (torch.zeros_like(met),) * 3
    pi = torch.tensor(PI, dtype=met.dtype, device=met.device)
    for i in range(lights["pos"].shape[0]):
        lpos, ldir = lights["pos"][i], lights["dir"][i]
        ltype = int(lights["type"][i])
        to_l = tuple(lpos[c] - world[c] for c in range(3))
        d2 = torch.clamp(_dot3(to_l, to_l), min=1e-20)
        inv_d = 1.0 / torch.sqrt(d2)
        l_point = tuple(to_l[c] * inv_d for c in range(3))
        att_point = 1.0 / d2
        dlen = torch.clamp(torch.sqrt(ldir[0] * ldir[0] + ldir[1] * ldir[1]
                                      + ldir[2] * ldir[2]), min=1e-20)
        dn = (ldir[0] / dlen, ldir[1] / dlen, ldir[2] / dlen)
        eps = lights["inner_cutoff"][i] - lights["outer_cutoff"][i]
        theta = -(l_point[0] * dn[0] + l_point[1] * dn[1]
                  + l_point[2] * dn[2])
        outer = lights["outer_cutoff"][i]
        spot = torch.clamp((theta - outer) / torch.where(
            eps == 0, torch.ones_like(eps), eps), 0.0, 1.0)
        if ltype == sc.DIRECTIONAL:
            l_vec = tuple(-dn[c] + torch.zeros_like(met) for c in range(3))
            att = torch.ones_like(att_point)
        else:
            l_vec = l_point
            att = att_point * (spot if ltype == sc.SPOT
                               else torch.ones_like(spot))
        h = _normalize3(tuple(l_vec[c] + v[c] for c in range(3)))
        a = rough * rough
        a2 = a * a
        ndh = torch.clamp(_dot3(n, h), min=0.0)
        denom = ndh * ndh * (a2 - 1.0) + 1.0
        d = a2 / (PI * denom * denom)
        hdv = torch.clamp(_dot3(h, v), min=0.0)
        x = 1.0 - hdv
        x2 = x * x
        fres = x * (x2 * x2)
        f = tuple(f0[c] + (1.0 - f0[c]) * fres for c in range(3))
        r1 = rough + 1.0
        kk = (r1 * r1) / 8.0
        ndv = torch.clamp(_dot3(n, v), min=0.0)
        ndl = torch.clamp(_dot3(n, l_vec), min=0.0)
        g = (ndv / (ndv * (1.0 - kk) + kk)) * (ndl / (ndl * (1.0 - kk) + kk))
        spec_den = 1.0 / torch.clamp(4.0 * ndv * ndl, min=0.001)
        radiance = att * lights["intensity"][i]
        if vis is not None and i in vis:
            radiance = radiance * vis[i]
        lo = tuple(lo[c] + ((1.0 - f[c]) * (1.0 - met) * albedo[c] / pi
                            + (d * f[c] * g) * spec_den)
                   * (radiance * lights["color"][i][c]) * ndl
                   for c in range(3))
    return lo


def srgb_encode(lin):
    lin = torch.clamp(lin, 0.0, 1.0)
    return torch.where(lin <= 0.0031308, lin * 12.92,
                       1.055 * torch.pow(lin, 1.0 / 2.4) - 0.055)


# -- the frame ---------------------------------------------------------------

def _corner_planes(positions, idx):
    """(V, k) array → per channel the three per-corner (T,) planes."""
    return tuple(tuple(positions[idx[:, c], k] for c in range(3))
                 for k in range(positions.shape[1]))


class Reference:
    """The reference frame of :class:`FrameInputs` on ``device``, every
    floating-point step in ``dtype``."""

    def __init__(self, inputs: FrameInputs, device, dtype=torch.float32):
        self.inp = inputs
        self.dev = torch.device(device)
        self.dt = dtype

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=self.dev).to(dt)

        ball, plane = inputs.ball, generate_plane_mesh()
        model, inv = sc.instance_matrices(inputs.num_instances,
                                          inputs.angle)
        pmodel, pinv = sc.plane_matrices()
        # De-indexed corners, instance-major, then the plane (draw order).
        self.batches = []
        for mesh, m, mi in ((ball, model, inv), (plane, pmodel, pinv)):
            flat = np.asarray(mesh.indices, np.int64)
            self.batches.append(dict(
                pos=tuple(t(np.asarray(mesh.positions, np.float32)[
                    flat[:, c]].T) for c in range(3)),
                nrm=tuple(t(np.asarray(mesh.normals, np.float32)[
                    flat[:, c]].T) for c in range(3)),
                uv=tuple(t(np.asarray(mesh.uvs, np.float32)[flat[:, c]].T)
                         for c in range(3)),
                model=t(m), nmat=t(mi)[:, :3, :3].transpose(-1, -2)))
        la = sc.light_arrays(inputs.lights)
        self.lights = {k: (t(v, torch.int32) if k == "type" else t(v))
                       for k, v in la.items()}
        self.lights["type"] = la["type"]
        self.maps = {k: torch.as_tensor(np.array(v), device=self.dev)
                     for k, v in inputs.maps.items()}
        sphere = generate_uv_sphere_mesh(*sc.LIGHT_SPHERE)
        self.sphere = (t(sphere.positions), torch.as_tensor(
            sphere.indices, device=self.dev).long())
        g = inputs.gizmo
        self.gizmo = None if g is None else dict(
            pos=t(g.positions), nrm=t(g.normals), col=t(g.colors),
            tris=torch.as_tensor(g.indices, device=self.dev).long())
        self.proj = sc.perspective(inputs.width / inputs.height).to(
            self.dev).to(dtype)

    # -- passes --------------------------------------------------------------

    def _vertex_stage(self, view_proj):
        """Every batch's corners: clip ((x, y, z, w) × 3 corners), world,
        normal, uv; per-corner (T,) planes in draw order."""
        parts = []
        for b in self.batches:
            m, nm = b["model"], b["nmat"]

            def affine(rows, p):  # (I, 4) rows × (F,) planes → (I·F,)
                return (rows[:, 0:1] * p[0][None, :] + rows[:, 1:2]
                        * p[1][None, :] + rows[:, 2:3] * p[2][None, :]
                        + rows[:, 3:4]).reshape(-1)

            def rot(rows, p):
                return (rows[:, 0:1] * p[0][None, :] + rows[:, 1:2]
                        * p[1][None, :] + rows[:, 2:3] * p[2][None, :])

            corners = []
            n_inst = m.shape[0]
            for c in range(3):
                p = b["pos"][c]
                world = tuple(affine(m[:, r, :], p) for r in range(3))
                clip = tuple(view_proj[k, 0] * world[0]
                             + view_proj[k, 1] * world[1]
                             + view_proj[k, 2] * world[2] + view_proj[k, 3]
                             for k in range(4))
                nr = tuple(rot(nm[:, r, :], b["nrm"][c]) for r in range(3))
                inv = torch.reciprocal(torch.clamp(torch.sqrt(
                    nr[0] * nr[0] + nr[1] * nr[1] + nr[2] * nr[2]),
                    min=1e-20))
                nrm = tuple((x * inv).reshape(-1) for x in nr)
                uv = tuple(b["uv"][c][k][None, :].expand(
                    n_inst, -1).reshape(-1) for k in range(2))
                corners.append((clip, world, nrm, uv))
            parts.append(corners)

        def cat(j, k):
            return tuple(torch.cat([p[c][j][k] for p in parts])
                         for c in range(3))

        return (tuple(cat(0, k) for k in range(4)),
                {"w" + "xyz"[k]: cat(1, k) for k in range(3)}
                | {"n" + "xyz"[k]: cat(2, k) for k in range(3)}
                | {"u": cat(3, 0), "v": cat(3, 1)})

    def _main_pass(self, view_proj):
        w, h = self.inp.width, self.inp.height
        clip, attrs = self._vertex_stage(view_proj)
        s = setup(clip, w, h)
        tri, key = raster(s, w, h)
        return s, tri, key, resolve(s, tri, attrs, w, h)

    def _shade(self, tri, px, view_pos):
        """The deferred G-buffer and lighting → tone-mapped LDR planes."""
        valid = tri >= 0
        zero = torch.zeros((), dtype=self.dt, device=self.dev)
        u, v = px["u"], px["v"]

        def sample(kind, channels):
            tex = self.maps[kind]
            order = ("weights" if tex.shape[0] * tex.shape[1]
                     > WEIGHTS_ORDER_TEXELS else "rows")
            return bilinear(tex[:, :, :channels], u, v, order)

        def mq(x):
            return q16(torch.where(valid, x, zero))

        world = tuple(mq(px["w" + a]) for a in "xyz")
        nrm = tuple(mq(px["n" + a]) for a in "xyz")
        alb = tuple(mq(c) for c in sample("albedo", 3))
        rough = mq(sample("roughness", 1)[0])
        met = mq(sample("metallic", 1)[0])
        ao = mq(sample("ao", 1)[0])
        n3 = _normalize3(nrm)
        v3 = _normalize3(tuple(view_pos[c] - world[c] for c in range(3)))
        f0 = tuple(0.04 * (1.0 - met) + alb[c] * met for c in range(3))
        lo = ggx(self.lights, world, n3, v3, alb, f0, met, rough,
                 self._visibility(px))
        amb = self._ambient(world, nrm, view_pos, alb, met, rough, ao)
        hdr = tuple(q16(torch.where(valid, amb[c] + lo[c], zero))
                    for c in range(3))
        if not self.inp.tone_map:
            return hdr
        return tuple(1.0 - torch.exp(-c * self.inp.exposure) for c in hdr)

    def _visibility(self, px) -> dict | None:
        """Light index → visibility plane of the resolved pixels ``px``
        (None: every light unshadowed)."""
        return None

    def _ambient(self, world, nrm, view_pos, alb, met, rough, ao):
        """The ambient term from the G-buffer planes: 0.03·albedo·ao."""
        return tuple(0.03 * alb[c] * ao for c in range(3))

    def _spheres(self, ldr, key, view_proj):
        """The light spheres over ``ldr`` where their depth key is at
        least the scene's."""
        w, h = self.inp.width, self.inp.height
        vs, tris = self.sphere
        lp = self.lights["pos"]
        nl, f = lp.shape[0], tris.shape[0]
        world = tuple(vs[tris[:, c]][None, :, :] + lp[:, None, :]
                      for c in range(3))  # corner → (L, F, 3)
        clip = tuple(tuple((view_proj[k, 0] * world[c][..., 0]
                            + view_proj[k, 1] * world[c][..., 1]
                            + view_proj[k, 2] * world[c][..., 2]
                            + view_proj[k, 3]).reshape(-1)
                           for c in range(3)) for k in range(4))
        s = setup(clip, w, h)
        tri, skey = raster(s, w, h)
        win = (tri >= 0) & (skey >= key)
        col = self.lights["color"]
        cols = {str(ch): tuple(col[:, ch, None].expand(nl, f).reshape(-1)
                               for _ in range(3)) for ch in range(3)}
        rgb = resolve(s, torch.where(win, tri, -1), cols, w, h)
        return (tuple(torch.where(win, rgb[str(c)], ldr[c])
                      for c in range(3)), win.reshape(h, w))

    def _gizmo_pass(self, view):
        """The gizmo's own viewport: its setup, winners and attributes."""
        ext = self.inp.gizmo_extent
        g = self.gizmo
        gz_view, vp = sc.gizmo_camera(view, self.proj)
        p4 = torch.cat([g["pos"], torch.ones_like(g["pos"][:, :1])], dim=1)
        clip = _corner_planes(torch.matmul(p4, vp.T), g["tris"])
        s = setup(clip, ext, ext)
        tri, _ = raster(s, ext, ext)
        att = resolve(s, tri, {
            **{f"n{k}": c for k, c in enumerate(_corner_planes(
                g["nrm"], g["tris"]))},
            **{f"c{k}": c for k, c in enumerate(_corner_planes(
                g["col"], g["tris"]))}}, ext, ext)
        return s, tri, att, gz_view

    def _gizmo(self, ldr, view):
        """The gizmo's viewport over the frame's top-right corner."""
        ext, w = self.inp.gizmo_extent, self.inp.width
        _, tri, att, gz_view = self._gizmo_pass(view)
        rot = gz_view[:3, :3]
        nv = tuple(rot[r, 0] * att["n0"] + rot[r, 1] * att["n1"]
                   + rot[r, 2] * att["n2"] for r in range(3))
        diff = torch.clamp(-_normalize3(nv)[2], min=0.0)
        hit = (tri >= 0).reshape(ext, ext)
        ex = min(ext, w)
        rows = min(ext, self.inp.height)
        out = []
        for c in range(3):
            img = ldr[c].clone()
            patch = (att[f"c{c}"] * diff).reshape(ext, ext)
            img[:rows, w - ex:] = torch.where(hit[:rows, :ex],
                                              patch[:rows, :ex],
                                              img[:rows, w - ex:])
            out.append(img)
        mask = torch.zeros((self.inp.height, w), dtype=torch.bool,
                           device=self.dev)
        mask[:rows, w - ex:] = hit[:rows, :ex]
        return out, mask

    def matrices(self, pos, yaw: float, pitch: float):
        view = torch.as_tensor(sc.view_matrix(pos, yaw, pitch),
                               device=self.dev).to(self.dt)
        view_pos = torch.as_tensor(np.asarray(pos, np.float32),
                                   device=self.dev).to(self.dt)
        return view, view_pos, torch.matmul(self.proj, view)

    def render(self, pos, yaw: float, pitch: float,
               overlay_mask: bool = False):
        """The (H, W, 3) uint8 frame of the camera pose (position, yaw and
        pitch in degrees); with ``overlay_mask``, (frame, mask), the mask
        (H, W) the pixels that show a light sphere or the gizmo."""
        w, h = self.inp.width, self.inp.height
        view, view_pos, vp = self.matrices(pos, yaw, pitch)
        _, tri, key, px = self._main_pass(vp)
        ldr = self._shade(tri, px, view_pos)
        del px
        mask = torch.zeros((h, w), dtype=torch.bool, device=self.dev)
        if self.inp.show_lights and self.lights["pos"].shape[0]:
            ldr, spheres = self._spheres(ldr, key, vp)
            mask |= spheres
        ldr = [c.reshape(h, w) for c in ldr]
        if self.inp.show_gizmo and self.gizmo is not None:
            ldr, gizmo = self._gizmo(ldr, view)
            mask |= gizmo
        img = torch.stack([srgb_encode(c) for c in ldr], dim=-1)
        img = torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        return (img, mask) if overlay_mask else img

    def facts(self) -> dict:
        """What the roofline counts read besides the passes: the number of
        lights and each sampled map's (height, width)."""
        return {"lights": len(self.inp.lights),
                "map_sizes": {k: tuple(v.shape[:2])
                              for k, v in self.inp.maps.items()}}

    def passes(self, pos, yaw: float, pitch: float) -> dict:
        """The raster passes of a pose (what the roofline counts read):
        "main" (setup, winners, uv planes, width, height) and, with the
        gizmo on, "gizmo" (setup, winners, its extent)."""
        w, h = self.inp.width, self.inp.height
        view, _, vp = self.matrices(pos, yaw, pitch)
        s, tri, _, px = self._main_pass(vp)
        out = {"main": dict(setup=s, tri=tri, u=px["u"], v=px["v"],
                            width=w, height=h)}
        if self.inp.show_gizmo and self.gizmo is not None:
            gs, gtri, _, _ = self._gizmo_pass(view)
            ext = self.inp.gizmo_extent
            out["gizmo"] = dict(setup=gs, tri=gtri, width=ext, height=ext)
        return out


# Faults planted in the reference put in the program's place, as
# configuration settings: what a frame handed back would leave out.
FAULTS = {"overlays": {"show_lights": False, "show_gizmo": False},
          "gizmo": {"show_gizmo": False}, "spheres": {"show_lights": False}}


def frame_inputs(config: dict, root) -> FrameInputs:
    """The inputs of a ShaderBall configuration's frame, from the stand-in
    resource root ``root``."""
    return FrameInputs(
        ball=writers.ball_mesh(), num_instances=config["num_instances"],
        maps=material_maps(root, config["material_index"]),
        lights=sc.shaderball_lights(), gizmo=writers.gizmo_mesh(),
        width=config["width"], height=config["height"],
        tone_map=config["tone_map"], exposure=config["exposure"],
        show_lights=config["show_lights"], show_gizmo=config["show_gizmo"])


def make(config: dict, root, device, dtype=torch.float32) -> Reference:
    """The reference of ``config``'s frame on ``device`` in ``dtype``."""
    return Reference(frame_inputs(config, root), device, dtype)
