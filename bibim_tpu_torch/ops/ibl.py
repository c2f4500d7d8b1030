"""Image-based lighting (port of ``bibim_tpu.ops.ibl``): the split-sum
ambient that replaces the constant 0.03·albedo·ao when IBL is on.

Bind time (numpy, the JAX package's code as it is): the procedural sky
probe, cosine-power convolutions of it, and either

- :class:`IblSH` (the production path): each product fit as a low-degree
  polynomial on the sphere plus one spherical Gaussian for the sun lobe,
  evaluated at run time as elementwise torch ops; or
- :class:`IblMaps` (the table path): u8 equirect quad tables (16×32 and
  32×64), sampled at run time through ``texture_quad.sample_material``,
  i.e. through K7 when the frame's kernels are given.

The environment BRDF is Karis' analytic approximation (no LUT).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.shading_planar import dot3, normalize3


class IblMaps(NamedTuple):
    """Precomputed environment products as quad tables (slots alb_r/g/b)."""

    irradiance: tuple
    spec_gloss: tuple  # low-roughness prefilter
    spec_rough: tuple  # high-roughness prefilter
    hdr_scale: float  # dequantization scale


def make_procedural_sky(h: int = 64, w: int = 128,
                        sun_dir=(-0.4, -1.0, 0.5),
                        sun_color=(8.0, 7.0, 6.0),
                        zenith=(0.25, 0.45, 0.9),
                        horizon=(0.8, 0.75, 0.7),
                        ground=(0.25, 0.2, 0.17)) -> np.ndarray:
    """Analytic gradient sky + sun blob as an equirect HDR image (the
    renderer's default light probe; the reference ships no environment)."""
    v = (np.arange(h) + 0.5) / h * np.pi  # polar angle
    u = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    theta, phi = np.meshgrid(v, u, indexing="ij")
    dirs = np.stack(
        [np.sin(theta) * np.cos(phi), np.cos(theta),
         np.sin(theta) * np.sin(phi)], axis=-1,
    )
    y = dirs[..., 1]
    up = np.clip(y, 0.0, 1.0)[..., None]
    down = np.clip(-y, 0.0, 1.0)[..., None]
    sky = np.where(
        (y > 0)[..., None],
        np.asarray(horizon) + (np.asarray(zenith) - np.asarray(horizon))
        * up ** 0.7,
        np.asarray(horizon) + (np.asarray(ground) - np.asarray(horizon))
        * down ** 0.4,
    )
    sd = -np.asarray(sun_dir, np.float64)
    sd /= np.linalg.norm(sd)
    cos_sun = np.clip(dirs @ sd, 0.0, 1.0)
    sun = np.asarray(sun_color) * (cos_sun[..., None] ** 600)
    return (sky + sun).astype(np.float32)


def _equirect_dirs(h: int, w: int):
    """Unit directions + sinθ solid-angle weights of an equirect grid."""
    tv = (np.arange(h) + 0.5) / h * np.pi
    tu = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    et, ep = np.meshgrid(tv, tu, indexing="ij")
    dirs = np.stack(
        [np.sin(et) * np.cos(ep), np.cos(et), np.sin(et) * np.sin(ep)],
        axis=-1,
    ).reshape(-1, 3)
    return dirs, np.sin(et).reshape(-1)


def _convolve(env: np.ndarray, out_h: int, out_w: int,
              power: float) -> np.ndarray:
    """Brute-force cosine-power convolution of an equirect map, chunked
    over output pixels."""
    eh, ew = env.shape[:2]
    env_dirs, solid = _equirect_dirs(eh, ew)
    texels = env.reshape(-1, 3)
    out_dirs, _ = _equirect_dirs(out_h, out_w)

    out = np.empty((out_h * out_w, 3), np.float32)
    for lo in range(0, out_dirs.shape[0], 1024):
        chunk = out_dirs[lo:lo + 1024]
        cosw = np.clip(chunk @ env_dirs.T, 0.0, 1.0) ** power  # (o, E)
        wsum = cosw * solid[None, :]
        out[lo:lo + 1024] = (wsum @ texels) / np.maximum(
            wsum.sum(axis=1, keepdims=True), 1e-9)
    return out.reshape(out_h, out_w, 3).astype(np.float32)


def _to_quads(img: np.ndarray, scale: float, device) -> tuple:
    q = np.clip(img / scale * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return tq.build_quad_tables(
        {"alb_r": q[:, :, 0:1], "alb_g": q[:, :, 1:2], "alb_b": q[:, :, 2:3]},
        device=device)


def make_ibl(env: np.ndarray | None = None, out_h: int = 16,
             out_w: int = 32, device="cuda") -> IblMaps:
    """The table-path IBL products of an equirect HDR env (default: the
    procedural sky)."""
    if env is None:
        env = make_procedural_sky()
    irr = _convolve(env, out_h, out_w, power=1.0)
    gloss = _convolve(env, out_h * 2, out_w * 2, power=160.0)
    rough = _convolve(env, out_h, out_w, power=6.0)
    scale = float(max(irr.max(), gloss.max(), rough.max(), 1e-6))
    return IblMaps(
        irradiance=_to_quads(irr, scale, device),
        spec_gloss=_to_quads(gloss, scale, device),
        spec_rough=_to_quads(rough, scale, device),
        hdr_scale=scale,
    )


class SphPoly(NamedTuple):
    """color(d) ≈ Σ_b coef[b]·x^i y^j z^k + sg_amp·exp(sg_sharp·(d·a − 1))
    for unit d."""

    coef: torch.Tensor  # (nbasis, 3) f32
    sg_axis: torch.Tensor  # (3,) f32 unit
    sg_amp: torch.Tensor  # (3,) f32 (zeros = no SG)
    sg_sharp: torch.Tensor  # () f32
    degree: int


class IblSH(NamedTuple):
    """Analytic IBL products."""

    irradiance: SphPoly
    spec_gloss: SphPoly
    spec_rough: SphPoly


def _monomial_powers(degree: int):
    return [(i, j, k)
            for total in range(degree + 1)
            for i in range(total + 1)
            for j in range(total - i + 1)
            for k in (total - i - j,)]


def _monomials_np(dirs: np.ndarray, degree: int) -> np.ndarray:
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    cols = [x ** i * y ** j * z ** k
            for i, j, k in _monomial_powers(degree)]
    return np.stack(cols, axis=1)


def _fit_sph_poly_np(img: np.ndarray, degree: int, with_sg: bool,
                     iters: int = 4):
    """Weighted least-squares fit of an equirect product map → numpy
    (coef, sg_axis, sg_amp, sg_sharp). With ``with_sg``, alternate
    SG-on-residual / poly-on-remainder so the poly never has to ring
    around the sun lobe."""
    h, w = img.shape[:2]
    dirs, solid = _equirect_dirs(h, w)
    y = img.reshape(-1, 3).astype(np.float64)
    sw = np.sqrt(solid)[:, None]
    basis = _monomials_np(dirs, degree)

    def poly_fit(target):
        c, *_ = np.linalg.lstsq(basis * sw, target * sw, rcond=None)
        return c

    sg_axis = np.array([0.0, 1.0, 0.0])
    sg_amp = np.zeros(3)
    sg_sharp = 1.0
    coef = poly_fit(y)
    if with_sg:
        lams = np.exp(np.linspace(np.log(4.0), np.log(2048.0), 28))
        for _ in range(iters):
            resid = y - basis @ coef
            lum = resid @ np.array([0.2126, 0.7152, 0.0722])
            peak = int(np.argmax(lum))
            # refine the axis as the energy centroid near the peak
            near = np.clip(dirs @ dirs[peak], 0.0, None) ** 64
            wgt = np.clip(lum, 0.0, None) * near * solid
            axis = dirs.T @ wgt
            nrm = np.linalg.norm(axis)
            sg_axis = axis / nrm if nrm > 1e-12 else dirs[peak]
            mu = dirs @ sg_axis
            best = (np.inf, None, None)
            for lam in lams:
                g = np.exp(lam * (mu - 1.0))
                denom = float(np.sum(solid * g * g))
                if denom < 1e-12:
                    continue
                amp = (g * solid) @ resid / denom
                err = float(np.sum(
                    solid[:, None] * (resid - g[:, None] * amp[None]) ** 2))
                if err < best[0]:
                    best = (err, lam, amp)
            _, sg_sharp, sg_amp = best
            sg_amp = np.maximum(sg_amp, 0.0)
            g = np.exp(sg_sharp * (dirs @ sg_axis - 1.0))
            coef = poly_fit(y - g[:, None] * sg_amp[None])
    return coef, sg_axis, sg_amp, sg_sharp


def sph_poly(coef, sg_axis, sg_amp, sg_sharp, degree: int,
             device="cuda") -> SphPoly:
    """SphPoly with float32 tensors on ``device``."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return SphPoly(coef=t(coef), sg_axis=t(sg_axis), sg_amp=t(sg_amp),
                   sg_sharp=t(sg_sharp), degree=int(degree))


def _fit_sph_poly(img: np.ndarray, degree: int, with_sg: bool,
                  device="cuda") -> SphPoly:
    return sph_poly(*_fit_sph_poly_np(img, degree, with_sg), degree,
                    device=device)


def sph_poly_error(poly: SphPoly, img: np.ndarray) -> float:
    """Max abs fit error over the map grid, relative to the map max."""
    h, w = img.shape[:2]
    dirs, _ = _equirect_dirs(h, w)
    got = _monomials_np(dirs, poly.degree) @ \
        poly.coef.cpu().numpy().astype(np.float64)
    amp = poly.sg_amp.cpu().numpy().astype(np.float64)
    if amp.any():
        g = np.exp(float(poly.sg_sharp) * (
            dirs @ poly.sg_axis.cpu().numpy().astype(np.float64) - 1.0))
        got = got + g[:, None] * amp[None]
    err = np.abs(got - img.reshape(-1, 3).astype(np.float64))
    return float(err.max() / max(float(img.max()), 1e-9))


def make_ibl_sh(env: np.ndarray | None = None, device="cuda") -> IblSH:
    """The analytic IBL products (production path); the convolved maps
    exist only as fit targets."""
    if env is None:
        env = make_procedural_sky()
    irr = _convolve(env, 16, 32, power=1.0)
    rough = _convolve(env, 24, 48, power=6.0)
    gloss = _convolve(env, 48, 96, power=160.0)
    return IblSH(
        irradiance=_fit_sph_poly(irr, 2, False, device),
        spec_gloss=_fit_sph_poly(gloss, 4, True, device),
        spec_rough=_fit_sph_poly(rough, 4, True, device),
    )


def _eval_sph_poly(p: SphPoly, d):
    """Evaluate a SphPoly at unit-direction planes (the reference's
    monomial and sum order)."""
    pows = []
    for plane in d:
        col = [None, plane]
        for _ in range(p.degree - 1):
            col.append(col[-1] * plane)
        pows.append(col)
    out = [None, None, None]
    for b, (i, j, k) in enumerate(_monomial_powers(p.degree)):
        mono = None
        for axis, power in ((0, i), (1, j), (2, k)):
            if power:
                term = pows[axis][power]
                mono = term if mono is None else mono * term
        for c in range(3):
            w = p.coef[b, c]
            term = w.expand_as(d[0]) if mono is None else mono * w
            out[c] = term if out[c] is None else out[c] + term
    g = torch.exp(p.sg_sharp * (
        d[0] * p.sg_axis[0] + d[1] * p.sg_axis[1] + d[2] * p.sg_axis[2]
        - 1.0))
    return tuple(torch.clamp(out[c] + p.sg_amp[c] * g, min=0.0)
                 for c in range(3))


def _dir_to_uv(d):
    """Equirect uv of unit direction planes: v = θ/π from +Y,
    u = (atan2(z, x) + π) / 2π."""
    dx, dy, dz = d
    u = (torch.atan2(dz, dx) + np.pi) / (2.0 * np.pi)
    v = torch.acos(torch.clamp(dy, -1.0, 1.0)) / np.pi
    return u, v


def _sample_env(tables, u, v, scale, kernels):
    s = tq.sample_material(tables, u, v, kernels)
    return tuple(s[k] * scale for k in ("alb_r", "alb_g", "alb_b"))


def ibl_ambient(ibl, normal, view_dir, albedo, metallic, roughness, ao,
                kernels=None):
    """Split-sum ambient from planar channel tuples/planes. ``ibl`` is an
    :class:`IblSH` (elementwise math) or :class:`IblMaps` (equirect table
    samples through ``texture_quad.sample_material(..., kernels)``)."""
    n = normalize3(normal)
    v = normalize3(view_dir)
    ndv = torch.clamp(dot3(n, v), min=0.0)
    # reflect(-v, n); unit because n and v are
    r = tuple(2.0 * ndv * n[c] - v[c] for c in range(3))

    if isinstance(ibl, IblSH):
        irr = _eval_sph_poly(ibl.irradiance, n)
        sg = _eval_sph_poly(ibl.spec_gloss, r)
        sr = _eval_sph_poly(ibl.spec_rough, r)
    else:
        ui, vi = _dir_to_uv(n)
        irr = _sample_env(ibl.irradiance, ui, vi, ibl.hdr_scale, kernels)
        ur, vr = _dir_to_uv(normalize3(r))
        sg = _sample_env(ibl.spec_gloss, ur, vr, ibl.hdr_scale, kernels)
        sr = _sample_env(ibl.spec_rough, ur, vr, ibl.hdr_scale, kernels)
    spec_env = tuple(sg[c] * (1.0 - roughness) + sr[c] * roughness
                     for c in range(3))

    # Karis analytic environment BRDF (mobile split-sum approximation):
    #   r = roughness·c0 + c1;  a004 = min(r.x², 2^(−9.28·NoV))·r.x + r.y
    #   AB = (−1.04, 1.04)·a004 + r.zw
    f0 = tuple(0.04 * (1.0 - metallic) + albedo[c] * metallic
               for c in range(3))
    rx = roughness * -1.0 + 1.0
    ry = roughness * -0.0275 + 0.0425
    rz = roughness * -0.572 + 1.04
    rw = roughness * 0.022 - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * ndv)) * rx + ry
    brdf_scale = -1.04 * a004 + rz
    brdf_bias = torch.clamp(1.04 * a004 + rw, min=0.0)

    ks = tuple(f0[c] * brdf_scale + brdf_bias for c in range(3))
    kd = tuple((1.0 - f0[c]) * (1.0 - metallic) for c in range(3))
    return tuple((kd[c] * albedo[c] * irr[c] + spec_env[c] * ks[c]) * ao
                 for c in range(3))
