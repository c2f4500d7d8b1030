"""Planar shading: Cook-Torrance GGX and flat Lambert (port of
``bibim_tpu.ops.shading_planar``). Every quantity is its own (NT, NPX)
plane; formulas and operation order follow brdf.frag / brdf.glsl, including
the spot cutoff quirk (radians compared against a cosine)."""

from __future__ import annotations

import torch

from bibim_tpu_torch.scene.lights import Lights

PI = 3.1415926535897932384626433832795


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize3(v, eps: float = 1e-20):
    inv = 1.0 / torch.clamp(torch.sqrt(dot3(v, v)), min=eps)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def apply_normal_map(normal, tangent, nmap, enable):
    """N = TBN · (2·tap − 1), B = cross(N, T); ``enable`` is a 0-dim int
    tensor (the normal-map toggle)."""
    b = cross3(normal, tangent)
    mx, my, mz = (nmap[0] * 2.0 - 1.0, nmap[1] * 2.0 - 1.0,
                  nmap[2] * 2.0 - 1.0)
    mapped = tuple(tangent[c] * mx + b[c] * my + normal[c] * mz
                   for c in range(3))
    on = enable != 0
    return tuple(torch.where(on, mapped[c], normal[c]) for c in range(3))


def fresnel_pow5(x):
    """(x)^5 as x · ((x·x)·(x·x)) — the reference's integer-power order."""
    x2 = x * x
    return x * (x2 * x2)


def light_terms(lights: Lights, i: int):
    """Per-light scalars (0-dim tensors) the light loop needs."""
    ldir = lights.dir[i]
    dlen = torch.clamp(torch.sqrt(ldir[0] * ldir[0] + ldir[1] * ldir[1]
                                  + ldir[2] * ldir[2]), min=1e-20)
    dn = (ldir[0] / dlen, ldir[1] / dlen, ldir[2] / dlen)
    return dn, lights.inner_cutoff[i] - lights.outer_cutoff[i]


def ggx_light_sum(lights: Lights, world, n, v, albedo, f0, met, rough):
    """The brdf.frag light loop → (r, g, b) outgoing radiance planes."""
    lo = (torch.zeros_like(met),) * 3
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal instead, which is not x / PI.
    pi = torch.tensor(PI, dtype=torch.float32, device=met.device)
    for i in range(lights.num_lights):
        lpos = lights.pos[i]
        ltype = lights.type[i]
        to_l = tuple(lpos[c] - world[c] for c in range(3))
        d2 = torch.clamp(dot3(to_l, to_l), min=1e-20)
        inv_d = 1.0 / torch.sqrt(d2)
        l_point = tuple(to_l[c] * inv_d for c in range(3))
        att_point = 1.0 / d2

        dn, eps = light_terms(lights, i)
        theta = -(l_point[0] * dn[0] + l_point[1] * dn[1]
                  + l_point[2] * dn[2])
        outer = lights.outer_cutoff[i]
        spot = torch.clamp((theta - outer) / torch.where(
            eps == 0, torch.ones_like(eps), eps), 0.0, 1.0)
        is_spot = ltype == 1
        is_dir = ltype == 2
        l_vec = tuple(torch.where(is_dir, -dn[c], l_point[c])
                      for c in range(3))
        att = torch.where(is_dir, torch.ones_like(att_point),
                          att_point * torch.where(is_spot, spot,
                                                  torch.ones_like(spot)))

        h = normalize3(tuple(l_vec[c] + v[c] for c in range(3)))
        a = rough * rough
        a2 = a * a
        ndh = torch.clamp(dot3(n, h), min=0.0)
        denom = ndh * ndh * (a2 - 1.0) + 1.0
        d = a2 / (PI * denom * denom)

        hdv = torch.clamp(dot3(h, v), min=0.0)
        fres = fresnel_pow5(1.0 - hdv)
        f = tuple(f0[c] + (1.0 - f0[c]) * fres for c in range(3))

        r1 = rough + 1.0
        kk = (r1 * r1) / 8.0
        ndv = torch.clamp(dot3(n, v), min=0.0)
        ndl = torch.clamp(dot3(n, l_vec), min=0.0)
        g = (ndv / (ndv * (1.0 - kk) + kk)) * (ndl / (ndl * (1.0 - kk) + kk))

        spec_den = 1.0 / torch.clamp(4.0 * ndv * ndl, min=0.001)
        radiance = att * lights.intensity[i]
        new = []
        for c in range(3):
            specular = (d * f[c] * g) * spec_den
            kd = (1.0 - f[c]) * (1.0 - met)
            new.append(lo[c] + (kd * albedo[c] / pi + specular)
                       * (radiance * lights.color[i][c]) * ndl)
        lo = tuple(new)
    return lo


def shade_pbr_planar(world, normal, albedo, metallic, roughness, ao,
                     lights: Lights, view_pos):
    """Full brdf.frag lighting → (r, g, b) linear HDR planes (ambient
    0.03·albedo·ao)."""
    n = normalize3(normal)
    v = normalize3(tuple(view_pos[c] - world[c] for c in range(3)))
    f0 = tuple(0.04 * (1.0 - metallic) + albedo[c] * metallic
               for c in range(3))
    lo = ggx_light_sum(lights, world, n, v, albedo, f0, metallic, roughness)
    return tuple(0.03 * albedo[c] * ao + lo[c] for c in range(3))


def shade_flat_planar(color, normal, view_rot):
    """gizmo.frag flat Lambert in view space: diff = max(-N_view.z, 0)."""
    n_view = tuple(view_rot[r, 0] * normal[0] + view_rot[r, 1] * normal[1]
                   + view_rot[r, 2] * normal[2] for r in range(3))
    n_unit = normalize3(n_view)
    diff = torch.clamp(-n_unit[2], min=0.0)
    return tuple(color[c] * diff for c in range(3))
