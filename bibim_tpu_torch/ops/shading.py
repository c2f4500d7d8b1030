"""Fused sampled shade — kernel K2 (replaces the JAX package's
``ops/shading_pallas.shade_sampled_pallas`` and its ``block_prep`` /
``small_prep`` glue, per-pixel sampling).

One pass from material tables to masked HDR planes: bilinear samples of
every size group (block tables and quad tables, rows read by index),
tangent-space normal map, the deferred G-buffer miss mask and RGBA16F
(fp16) round trip, the GGX light loop and the 0.03·albedo·ao ambient term.
The fp16 round trip of the HDR result and the tone map stay outside, as
torch ops, like the reference's.

:func:`shade_sampled` is the kernel wrapper (csrc/shade.cu for CUDA
tensors); :func:`shade_sampled_plain` is its plain version, run for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from bibim_tpu_torch import _build
from bibim_tpu_torch.ops import texture_quad as tq
from bibim_tpu_torch.ops.shading_planar import (
    apply_normal_map,
    ggx_light_sum,
    normalize3,
)
from bibim_tpu_torch.scene.lights import Lights, pack_lights


def q16(x: torch.Tensor) -> torch.Tensor:
    """RGBA16F attachment round trip (round to nearest even)."""
    return x.to(torch.float16).to(torch.float32)


def _sample_quad_blend(table: tq.QuadTable, u, v) -> dict:
    """Quad-table bilinear sample in the kernel's blend order:
    top/bottom rows first, then the vertical mix."""
    shape = u.shape
    idx, tx, ty = tq._footprint(u.reshape(-1), v.reshape(-1), table.height,
                                table.width)
    q = table.quads[idx.long()].to(torch.float32) * tq._INV255
    cpad = q.shape[1] // 4
    out = {}
    for k, slot in enumerate(table.present):
        top = q[:, k] * (1.0 - tx) + q[:, cpad + k] * tx
        bot = q[:, 2 * cpad + k] * (1.0 - tx) + q[:, 3 * cpad + k] * tx
        out[slot] = (top * (1.0 - ty) + bot * ty).reshape(shape)
    return out


def shade_sampled_plain(tables, u, v, world, normal, tangent, valid,
                        lights: Lights, view_pos, enable_normal_map,
                        gbuffer_mode: bool = True, quantize: bool = True):
    """Plain version of K2 → (r, g, b) masked HDR planes."""
    slots = {}
    for t in tables:
        if isinstance(t, tq.BlockTable):
            slots.update(tq.sample_table_block(t, u, v))
        else:
            slots.update(_sample_quad_blend(t, u, v))
    zero = torch.zeros_like(u)
    for s in tq.SLOTS:
        slots.setdefault(s, zero)
    albedo = (slots["alb_r"], slots["alb_g"], slots["alb_b"])
    nrm = apply_normal_map(normal, tangent,
                           (slots["nrm_x"], slots["nrm_y"], slots["nrm_z"]),
                           enable_normal_map)

    def mq(x):
        if gbuffer_mode:
            x = torch.where(valid, x, zero)
        if quantize:
            x = q16(x)
        return x

    world_q = tuple(mq(c) for c in world)
    nrm_q = tuple(mq(c) for c in nrm)
    alb_q = tuple(mq(c) for c in albedo)
    met_q, rough_q, ao_q = (mq(slots["metallic"]), mq(slots["roughness"]),
                            mq(slots["ao"]))
    n3 = normalize3(nrm_q)
    v3 = normalize3(tuple(view_pos[c] - world_q[c] for c in range(3)))
    f0 = tuple(0.04 * (1.0 - met_q) + alb_q[c] * met_q for c in range(3))
    lo = ggx_light_sum(lights, world_q, n3, v3, alb_q, f0, met_q, rough_q)
    hdr = tuple(0.03 * alb_q[c] * ao_q + lo[c] for c in range(3))
    return tuple(torch.where(valid, c, zero) for c in hdr)


def _groups(tables, device) -> _build.Groups:
    if len(tables) > _build.Groups.MAX_GROUPS:
        raise NotImplementedError(
            f"shade_sampled takes at most {_build.Groups.MAX_GROUPS} "
            f"material size groups, got {len(tables)}")
    g = _build.Groups()
    g.n = len(tables)
    for k, t in enumerate(tables):
        tab = t.blocks if isinstance(t, tq.BlockTable) else t.quads
        if (tab.dtype != torch.uint8 or tab.device != device
                or not tab.is_contiguous() or tab.ndim != 2):
            raise ValueError("material tables must be contiguous 2-D uint8 "
                             f"tensors on {device}")
        cpad = tq._ceil4(len(t.present))
        if isinstance(t, tq.BlockTable):
            if t.height % tq.BLOCK_B or t.width % tq.BLOCK_B:
                raise ValueError("block tables need B-divisible sizes")
            if tab.shape[1] < 25 * cpad:
                raise ValueError("block table rows too short")
            g.kind[k] = 0
        else:
            if tab.shape[1] != 4 * cpad:
                raise ValueError("quad table rows must hold 4·cpad bytes")
            g.kind[k] = 1
        g.tab[k] = tab.data_ptr()
        g.row_bytes[k] = tab.shape[1]
        g.h[k], g.w[k] = t.height, t.width
        g.cpad[k] = cpad
        g.n_present[k] = len(t.present)
        for j, s in enumerate(t.present):
            g.slot[k][j] = tq.SLOTS.index(s)
    return g


def shade_sampled(tables, u, v, world, normal, tangent, valid,
                  lights: Lights, view_pos, enable_normal_map,
                  gbuffer_mode: bool = True, quantize: bool = True):
    """K2 wrapper. ``tables``: tuple of QuadTable/BlockTable; pixel args
    (NT, NPX) float32 planes, ``valid`` bool; ``view_pos`` (3,) float32;
    ``enable_normal_map`` a 0-dim int tensor. Returns (r, g, b)."""
    dev = u.device
    shape = u.shape
    planes = [u, v, *world, *normal, *tangent]
    for name, t in zip(("u", "v", "wx", "wy", "wz", "nx", "ny", "nz", "tx",
                        "ty", "tz"), planes):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"shade_sampled: plane {name} must be a "
                             f"contiguous float32 {tuple(shape)} tensor on "
                             f"{dev}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(shape) \
            or valid.device != dev:
        raise ValueError("shade_sampled: valid must be a bool plane")
    if dev.type == "cpu":
        return shade_sampled_plain(tables, u, v, world, normal, tangent,
                                   valid, lights, view_pos,
                                   enable_normal_map, gbuffer_mode, quantize)
    if dev.type != "cuda":
        raise RuntimeError(f"shade_sampled: unsupported device {dev}")
    groups = _groups(tables, dev)
    lparams = pack_lights(lights)
    vp = view_pos.to(device=dev, dtype=torch.float32).reshape(3).contiguous()
    nm = enable_normal_map.to(device=dev, dtype=torch.int32).reshape(
        1).contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    out = torch.empty((3,) + tuple(shape), dtype=torch.float32, device=dev)
    p = _build.ptr
    n = u.numel()
    err = _build.library().bb_shade(
        ctypes.byref(groups), *(p(t) for t in planes), p(valid_u8),
        p(lparams), lights.num_lights, p(vp), p(nm), int(gbuffer_mode),
        int(quantize), n, p(out[0]), p(out[1]), p(out[2]),
        _build.stream_ptr(dev))
    _build.check(err, "shade")
    shade_sampled.launches += 1
    return out[0], out[1], out[2]


shade_sampled.launches = 0
