"""Plain reference of the ShaderBall frame with a shadow map and image-based
lighting (BASELINE config 5, ``bench.py`` ``bench_stretch_4k``), written
from its definition on top of :mod:`render`'s vertex stage, raster rule,
G-buffer rounding, GGX, light spheres, gizmo and encode:

(a) the light pass: light ``shadow_light`` (directional) renders depth
    only into a ``shadow_size``² reversed-Z orthographic frustum. The
    light looks along its direction at the middle of the scene's world
    box from twice its half-diagonal (+ 1e-3) back; the frustum's X and Y
    are fit to the caster batches' (the balls') box and its Z to the whole
    scene's, each range padded by 1.05 about its middle (+ 1e-3), the near
    plane at least 1e-4. Every triangle of the scene (balls and plane)
    rasterizes by :func:`render.raster`'s rule at texel centres (front
    faces as the light sees them; the nearest depth wins) and the winner's
    depth z / w at the texel centre is the map; texels nothing covers hold
    0 (far);
(b) the visibility: the pixel's world position (the raster's, before the
    G-buffer rounds it) into the light's clip space; outside the frustum
    (x or y outside [-1, 1], z outside [0, 1]) the pixel is lit (1); inside,
    2 x 2 bilinear PCF at texel centres, clamp-to-edge: a tap is lit where
    its depth is at most the pixel's z + ``shadow_bias``, and the four
    blend by the bilinear weights, top and bottom rows first. It scales
    that light's radiance in the GGX loop;
(c) the IBL ambient, replacing 0.03·albedo·ao: the procedural sky
    (:data:`SKY`, a 64 x 128 equirect map: a gradient from the horizon to
    the zenith and to the ground, and a sun lobe); its cosine-power
    convolutions (power 1 at 16 x 32, 6 at 24 x 48, 160 at 48 x 96), each
    the sinθ-weighted mean over the sky's texels of max(cos, 0)^power;
    least-squares fits of those on their grids, weighted by sinθ: degree 2
    for the irradiance, degree 4 plus one spherical Gaussian for the two
    specular products (:func:`fit_product`); evaluated at the G-buffer
    normal (irradiance) and the reflection vector (both specular products,
    blended by roughness), and combined by Karis' analytic environment
    BRDF (its bias clamped at 0): (kd·albedo·irradiance + specular·(f0·A
    + B))·ao, kd = (1 − f0)(1 − metallic).

The fits run on the host in float64, once a process, as a bind step; the
rest in ``dtype`` on the device. Departures from the program's path, none
of which changes a pixel's definition:

- the program computes the light pass every frame; the pose does not move
  it, so the reference computes it once;
- the program compacts PCF to the tiles whose covered pixels fall inside
  the frustum, and may run it at pair rate; the reference reads every
  pixel;
- the program pairs texel 0 with texel 1 in the map's first half texel
  (its 2 x 2 neighbourhoods are stored from the clamped top-left tap);
  the reference clamps each tap, so there both taps are texel 0;
- the program samples its material maps at pair rate where its router
  finds it exact; the reference samples every pixel.

Imports neither the program nor the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from h100_bench.reference import render as base
from h100_bench.reference import scene as sc

FAULTS = {"overlays": {"show_lights": False, "show_gizmo": False},
          "shadows": {"shadows": False}, "ibl": {"ibl": False}}

# The light frustum's padding about the middle of each fit range.
FIT_PAD = 1.05
# The procedural sky: equirect rows from +Y down, a gradient from the
# horizon colour to the zenith's (y^0.7) above and the ground's ((-y)^0.4)
# below, plus sun_color · max(cos to the sun, 0)^600; sun_dir is the
# direction its light travels.
SKY = dict(h=64, w=128, sun_dir=(-0.4, -1.0, 0.5), sun_color=(8.0, 7.0, 6.0),
           zenith=(0.25, 0.45, 0.9), horizon=(0.8, 0.75, 0.7),
           ground=(0.25, 0.2, 0.17), up_power=0.7, down_power=0.4,
           sun_power=600.0)
# Each product: (cosine power, grid height, grid width, polynomial
# degree, with a spherical Gaussian).
PRODUCTS = {"irradiance": (1.0, 16, 32, 2, False),
            "spec_rough": (6.0, 24, 48, 4, True),
            "spec_gloss": (160.0, 48, 96, 4, True)}
# The spherical Gaussian's fit: rounds of (Gaussian on the polynomial's
# residual, polynomial on the rest); the sharpness grid searched; the
# cosine power of the window about the residual's peak whose energy
# centroid is its axis.
SG_ROUNDS = 4
SG_SHARPNESS = np.exp(np.linspace(np.log(4.0), np.log(2048.0), 28))
SG_WINDOW = 64
LUMA = np.array([0.2126, 0.7152, 0.0722])


# -- the IBL products (bind step, float64 on the host) ------------------------

def equirect(h: int, w: int):
    """Unit directions (h·w, 3) of an equirect grid's texel centres (polar
    angle θ from +Y by rows, azimuth from −π by columns) and their sinθ."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                 axis=-1)
    return d.reshape(-1, 3), np.sin(t).reshape(-1)


def sky() -> np.ndarray:
    """The (64·128, 3) float32 sky texels of :data:`SKY`."""
    d, _ = equirect(SKY["h"], SKY["w"])
    y = d[:, 1:2]
    horizon = np.asarray(SKY["horizon"])
    above = horizon + (np.asarray(SKY["zenith"]) - horizon) \
        * np.clip(y, 0.0, 1.0) ** SKY["up_power"]
    below = horizon + (np.asarray(SKY["ground"]) - horizon) \
        * np.clip(-y, 0.0, 1.0) ** SKY["down_power"]
    to_sun = -np.asarray(SKY["sun_dir"], np.float64)
    to_sun /= np.linalg.norm(to_sun)
    sun = np.asarray(SKY["sun_color"]) \
        * np.clip(d @ to_sun, 0.0, 1.0)[:, None] ** SKY["sun_power"]
    return (np.where(y > 0, above, below) + sun).astype(np.float32)


def convolve(texels: np.ndarray, h: int, w: int,
             power: float) -> np.ndarray:
    """The (h·w, 3) float32 cosine-power convolution of the sky's texels:
    at each output direction the sinθ-weighted mean of the texels by
    max(cos, 0)^power."""
    src, solid = equirect(SKY["h"], SKY["w"])
    out, _ = equirect(h, w)
    res = np.empty((len(out), 3), np.float32)
    for lo in range(0, len(out), 1024):
        wgt = np.clip(out[lo:lo + 1024] @ src.T, 0.0, 1.0) ** power * solid
        res[lo:lo + 1024] = (wgt @ texels) / np.maximum(
            wgt.sum(axis=1, keepdims=True), 1e-9)
    return res


def monomials(degree: int) -> list:
    """(i, j, k) of x^i y^j z^k, by total degree, then i, then j."""
    return [(i, j, t - i - j) for t in range(degree + 1)
            for i in range(t + 1) for j in range(t - i + 1)]


def fit_product(img: np.ndarray, h: int, w: int, degree: int,
                with_sg: bool) -> dict:
    """The sinθ-weighted least-squares fit of a product map on its grid:
    a polynomial of ``degree`` in the direction's x, y, z, and with
    ``with_sg`` one spherical Gaussian amp · exp(sharp (d·axis − 1)),
    fit in :data:`SG_ROUNDS` rounds: the Gaussian on the polynomial's
    residual (axis: the energy centroid about the residual's luminance
    peak; sharpness: the least error over :data:`SG_SHARPNESS`, the
    amplitude its least-squares one, clamped at 0), then the polynomial
    on what the Gaussian leaves."""
    d, solid = equirect(h, w)
    y = img.astype(np.float64)
    basis = np.stack([d[:, 0] ** i * d[:, 1] ** j * d[:, 2] ** k
                      for i, j, k in monomials(degree)], axis=1)
    sw = np.sqrt(solid)[:, None]

    def poly(target):
        return np.linalg.lstsq(basis * sw, target * sw, rcond=None)[0]

    axis, amp, sharp = np.array([0.0, 1.0, 0.0]), np.zeros(3), 1.0
    coef = poly(y)
    for _ in range(SG_ROUNDS if with_sg else 0):
        resid = y - basis @ coef
        lum = resid @ LUMA
        peak = int(np.argmax(lum))
        window = np.clip(d @ d[peak], 0.0, None) ** SG_WINDOW
        centroid = d.T @ (np.clip(lum, 0.0, None) * window * solid)
        norm = np.linalg.norm(centroid)
        axis = centroid / norm if norm > 1e-12 else d[peak]
        mu = d @ axis
        best = (np.inf, None, None)
        for lam in SG_SHARPNESS:
            g = np.exp(lam * (mu - 1.0))
            den = float(np.sum(solid * g * g))
            if den < 1e-12:
                continue
            a = (g * solid) @ resid / den
            err = float(np.sum(solid[:, None]
                               * (resid - g[:, None] * a[None]) ** 2))
            if err < best[0]:
                best = (err, lam, a)
        _, sharp, amp = best
        amp = np.maximum(amp, 0.0)
        coef = poly(y - np.exp(sharp * (mu - 1.0))[:, None] * amp[None])
    return dict(coef=coef, axis=axis, amp=amp, sharp=float(sharp),
                degree=degree)


@functools.cache
def ibl_fits() -> dict:
    """Each product of :data:`PRODUCTS` fit (computed once a process)."""
    texels = sky()
    return {name: fit_product(convolve(texels, h, w, power), h, w, deg, sg)
            for name, (power, h, w, deg, sg) in PRODUCTS.items()}


# -- the frame ---------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _unit(v):
    return v / torch.clamp(torch.sqrt(_dot3(v, v)), min=1e-20)


def light_view_proj(light_dir, world_min, world_max, fit_min, fit_max):
    """(a)'s orthographic reversed-Z light view-projection (4, 4): the
    light at the scene box's middle from twice its half-diagonal back,
    X and Y fit to the casters' box, Z to the scene's."""
    d = _unit(light_dir)
    centre = (world_min + world_max) * 0.5
    ext = world_max - world_min
    radius = torch.sqrt(_dot3(ext, ext)) * 0.5 + 1e-3
    eye = centre - d * radius * 2.0
    one, zero = torch.ones_like(d[0]), torch.zeros_like(d[0])
    up = (torch.stack([one, zero, zero]) if abs(float(d[1])) > 0.99
          else torch.stack([zero, one, zero]))
    fwd = _unit(centre - eye)
    right = _unit(_cross3(up, fwd))
    upv = _unit(_cross3(fwd, right))
    rows = torch.stack([right, upv, fwd])
    view = torch.eye(4, dtype=d.dtype, device=d.device)
    view[:3, :3] = rows
    view[:3, 3] = -(rows @ eye)

    def box(lo, hi):  # the box's corners in light view → (min, max)
        c = torch.stack([torch.stack([hi[0] if i & 1 else lo[0],
                                      hi[1] if i & 2 else lo[1],
                                      hi[2] if i & 4 else lo[2], one])
                         for i in range(8)])
        v = c @ view.T
        return v.min(dim=0).values, v.max(dim=0).values

    lo, hi = box(world_min, world_max)
    flo, fhi = box(fit_min, fit_max)
    lo = torch.cat([flo[:2], lo[2:]])
    hi = torch.cat([fhi[:2], hi[2:]])
    mid = (lo + hi) * 0.5
    half = (hi - lo) * 0.5 * FIT_PAD + 1e-3
    lo, hi = mid - half, mid + half
    left, right_, bottom, top = lo[0], hi[0], lo[1], hi[1]
    near, far = torch.clamp(lo[2], min=1e-4), hi[2]
    proj = torch.zeros((4, 4), dtype=d.dtype, device=d.device)
    proj[0, 0] = 2.0 / (right_ - left)
    proj[0, 3] = -(right_ + left) / (right_ - left)
    proj[1, 1] = -(2.0 / (top - bottom))
    proj[1, 3] = (top + bottom) / (top - bottom)
    proj[2, 2] = -one / (far - near)
    proj[2, 3] = far / (far - near)
    proj[3, 3] = one
    return torch.matmul(proj, view)


def pcf(depth, cx, cy, cz, bias: float):
    """(b)'s visibility of light clip planes against the (S, S) depth
    map: clamp-to-edge 2 x 2 bilinear PCF at texel centres, 1 outside the
    frustum."""
    s = depth.shape[0]
    fx = (cx * 0.5 + 0.5) * s - 0.5
    fy = (cy * 0.5 + 0.5) * s - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    # Out-of-frustum pixels read a clamped texel and are set lit below.
    x0 = torch.nan_to_num(x0).clamp(-1, s).long()
    y0 = torch.nan_to_num(y0).clamp(-1, s).long()
    xs = (x0.clamp(0, s - 1), (x0 + 1).clamp(0, s - 1))
    ys = (y0.clamp(0, s - 1), (y0 + 1).clamp(0, s - 1))
    ref = cz + bias

    def lit(yi, xi):
        return (depth[yi, xi] <= ref).to(cz.dtype)

    top = lit(ys[0], xs[0]) * (1.0 - tx) + lit(ys[0], xs[1]) * tx
    bot = lit(ys[1], xs[0]) * (1.0 - tx) + lit(ys[1], xs[1]) * tx
    vis = top * (1.0 - ty) + bot * ty
    inside = ((cx >= -1.0) & (cx <= 1.0) & (cy >= -1.0) & (cy <= 1.0)
              & (cz >= 0.0) & (cz <= 1.0))
    return torch.where(inside, vis, torch.ones_like(vis))


def _eval_fit(f: dict, d, dtype, device):
    """A product's fit at unit-direction planes ``d``, clamped at 0."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(dtype)

    coef = t(f["coef"])
    axis, amp = t(f["axis"]), t(f["amp"])
    # pows[k][n] = d[k]^n, n >= 1, by repeated products.
    pows = [[None, p] for p in d]
    for col in pows:
        for _ in range(f["degree"] - 1):
            col.append(col[-1] * col[1])
    out = [torch.zeros_like(d[0]) for _ in range(3)]
    for b, powers in enumerate(monomials(f["degree"])):
        mono = None
        for k, n in enumerate(powers):
            if n:
                mono = pows[k][n] if mono is None else mono * pows[k][n]
        for c in range(3):
            out[c] = out[c] + (coef[b, c] if mono is None
                               else mono * coef[b, c])
    g = torch.exp(t(f["sharp"]) * (_dot3(d, axis) - 1.0))
    return tuple(torch.clamp(out[c] + amp[c] * g, min=0.0) for c in range(3))


class Reference(base.Reference):
    """:class:`render.Reference` with (a)-(c): ``shadows`` on, the light
    ``shadow_light`` shadowed through a ``shadow_size``² map with
    ``shadow_bias``; ``ibl`` on, the IBL ambient."""

    def __init__(self, inputs, device, dtype=torch.float32, *,
                 shadows: bool, shadow_size: int, shadow_bias: float,
                 shadow_light: int, ibl: bool):
        super().__init__(inputs, device, dtype)
        self.shadows, self.ibl = shadows, ibl
        self.shadow_size, self.shadow_bias = shadow_size, shadow_bias
        self.shadow_light = shadow_light
        if shadows and int(self.lights["type"][shadow_light]) \
                != sc.DIRECTIONAL:
            raise ValueError(f"light {shadow_light} casts the shadow map "
                             "and is not directional")
        self._light = None

    def light_pass(self) -> dict:
        """(a), computed once: the light view-projection ("vp"), the setup,
        the winners and the (S, S) depth map."""
        if self._light is None:
            self._light = self._light_pass()
        return self._light

    def _light_pass(self) -> dict:
        eye = torch.eye(4, dtype=self.dt, device=self.dev)
        _, attrs = self._vertex_stage(eye)
        world = [attrs["w" + a] for a in "xyz"]  # axis → corner planes
        # The casters: the balls, first in draw order.
        n_ball = (self.batches[0]["model"].shape[0]
                  * self.batches[0]["pos"][0].shape[1])

        def bounds(sl):
            lo = torch.stack([torch.stack([p[sl] for p in world[k]]).min()
                              for k in range(3)])
            hi = torch.stack([torch.stack([p[sl] for p in world[k]]).max()
                              for k in range(3)])
            return lo, hi

        wmin, wmax = bounds(slice(None))
        fmin, fmax = bounds(slice(0, n_ball))
        vp = light_view_proj(self.lights["dir"][self.shadow_light], wmin,
                             wmax, fmin, fmax)
        clip = tuple(tuple(vp[m, 0] * world[0][c] + vp[m, 1] * world[1][c]
                           + vp[m, 2] * world[2][c] + vp[m, 3]
                           for c in range(3)) for m in range(4))
        size = self.shadow_size
        s = base.setup(clip, size, size)
        tri, _ = base.raster(s, size, size)
        px, py = base.pixel_centres(size, size, self.dev, self.dt)
        hit = tri >= 0
        idx = torch.clamp(tri, min=0)
        zn = s["z"][0][idx] * px + s["z"][1][idx] * py + s["z"][2][idx]
        wn = s["w"][0][idx] * px + s["w"][1][idx] * py + s["w"][2][idx]
        depth = torch.where(
            hit, zn * (1.0 / torch.where(wn == 0.0, torch.ones_like(wn), wn)),
            torch.zeros_like(zn))
        return dict(vp=vp, setup=s, tri=tri, depth=depth.reshape(size, size))

    def _visibility(self, px):
        if not self.shadows:
            return None
        lp = self.light_pass()
        vp = lp["vp"]
        wx, wy, wz = px["wx"], px["wy"], px["wz"]
        cx, cy, cz = (vp[r, 0] * wx + vp[r, 1] * wy + vp[r, 2] * wz + vp[r, 3]
                      for r in range(3))
        return {self.shadow_light: pcf(lp["depth"], cx, cy, cz,
                                       self.shadow_bias)}

    def _ambient(self, world, nrm, view_pos, alb, met, rough, ao):
        if not self.ibl:
            return super()._ambient(world, nrm, view_pos, alb, met, rough,
                                    ao)
        n = base._normalize3(nrm)
        v = base._normalize3(tuple(view_pos[c] - world[c] for c in range(3)))
        ndv = torch.clamp(_dot3(n, v), min=0.0)
        r = tuple(2.0 * ndv * n[c] - v[c] for c in range(3))
        fits = ibl_fits()
        irr = _eval_fit(fits["irradiance"], n, self.dt, self.dev)
        gloss = _eval_fit(fits["spec_gloss"], r, self.dt, self.dev)
        rough_env = _eval_fit(fits["spec_rough"], r, self.dt, self.dev)
        spec = tuple(gloss[c] * (1.0 - rough) + rough_env[c] * rough
                     for c in range(3))
        # Karis' analytic environment BRDF: c = rough·c0 + c1,
        # a004 = min(c.x², 2^(−9.28 NoV))·c.x + c.y,
        # (A, B) = (−1.04, 1.04)·a004 + c.zw, B clamped at 0.
        f0 = tuple(0.04 * (1.0 - met) + alb[c] * met for c in range(3))
        cx = rough * -1.0 + 1.0
        cy = rough * -0.0275 + 0.0425
        cz = rough * -0.572 + 1.04
        cw = rough * 0.022 - 0.04
        a004 = torch.minimum(cx * cx, torch.exp2(-9.28 * ndv)) * cx + cy
        scale = -1.04 * a004 + cz
        bias = torch.clamp(1.04 * a004 + cw, min=0.0)
        return tuple(((1.0 - f0[c]) * (1.0 - met) * alb[c] * irr[c]
                      + spec[c] * (f0[c] * scale + bias)) * ao
                     for c in range(3))

    def passes(self, pos, yaw: float, pitch: float) -> dict:
        """:meth:`render.Reference.passes` and, with shadows on, the light
        pass "shadow" (setup, winners, its size), which K1 rasterizes too."""
        out = super().passes(pos, yaw, pitch)
        if self.shadows:
            lp = self.light_pass()
            out["shadow"] = dict(setup=lp["setup"], tri=lp["tri"],
                                 width=self.shadow_size,
                                 height=self.shadow_size)
        return out


def make(config: dict, root, device, dtype=torch.float32) -> Reference:
    """The reference of ``config``'s frame: :func:`render.make`'s inputs
    with ``shadows``, ``shadow_size``, ``shadow_bias``, ``shadow_light``
    and ``ibl``."""
    return Reference(base.frame_inputs(config, root), device, dtype,
                     shadows=config["shadows"],
                     shadow_size=config["shadow_size"],
                     shadow_bias=config["shadow_bias"],
                     shadow_light=config["shadow_light"], ibl=config["ibl"])
