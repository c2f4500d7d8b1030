"""The shading kernels (port of the JAX package's
``ops/shading_pallas``).

K2, fused sampled shade (replaces ``shade_sampled_pallas`` and its
``block_prep`` / ``small_prep`` glue, per-pixel sampling): one pass from
material tables to masked HDR planes — bilinear samples of every size
group (block tables and quad tables, rows read by index), tangent-space
normal map, the deferred G-buffer miss mask and RGBA16F (fp16) round trip,
the GGX light loop with the optional shadow visibility plane, and the
0.03·albedo·ao ambient term; optionally (``quantize_hdr``, ``tonemap``)
also the frame's tail, the fp16 round trip of the HDR result and the tone
map, so that it returns LDR planes.

K5, G-buffer shade (replaces ``shade_tonemap_pallas``): the GGX light loop
over G-buffer planes with the optional visibility plane and IBL ambient
planes, fp16 round trip and exposure tone map.

Both kernels write the miss value at a pixel whose ``valid`` is false and
read nothing else there, so the input planes may hold anything at misses
(the plain versions give the same output for any such values).

:func:`shade_sampled` and :func:`shade_tonemap` are the kernel wrappers
(csrc/shade.cu, csrc/gbuffer_shade.cu for CUDA tensors);
:func:`shade_sampled_plain` and :func:`shade_tonemap_plain` are their plain
versions, run for CPU tensors.
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
    shade_pbr_planar,
)
from bibim_tpu_torch.ops.tonemap import tone_map
from bibim_tpu_torch.scene.lights import Lights, pack_lights

# Row alignment the kernels' word loads need (16-byte quad-row vectors).
_TABLE_ALIGN = 16


def q16(x: torch.Tensor) -> torch.Tensor:
    """RGBA16F attachment round trip (round to nearest even)."""
    return x.to(torch.float16).to(torch.float32)


def hdr_tail(hdr, quantize: bool, tonemap: bool, enable_tone_mapping,
             exposure) -> tuple:
    """The frame's tail after a shading kernel, as torch ops: the HDR fp16
    round trip, then the exposure tone map (the kernels' epilogue)."""
    if quantize:
        hdr = tuple(q16(c) for c in hdr)
    if tonemap:
        hdr = tuple(tone_map(c, enable_tone_mapping, exposure) for c in hdr)
    return tuple(hdr)


def _light_vis(vis_plane, vis_light: int) -> dict | None:
    return None if vis_plane is None else {vis_light: vis_plane}


def sampled_groups_supported(tables) -> bool:
    """True for the bindings K2 samples in-kernel: QuadTable / BlockTable
    groups (one material), MipBlockMulti and single-level MipQuadMulti
    groups (merged materials, routed per pixel)."""
    return len(tables) <= _build.Groups.MAX_GROUPS and all(
        isinstance(t, (tq.QuadTable, tq.BlockTable, tq.MipBlockMulti))
        or (isinstance(t, tq.MipQuadMulti)
            and all(len(h) == 1 for h in t.heights))
        for t in tables)


def _sample_groups_plain(tables, u, v, mat_id, tile_h, tile_w) -> dict:
    slots = {}
    for t in tables:
        if isinstance(t, tq.BlockTable):
            slots.update(tq.sample_table_block(t, u, v))
        elif isinstance(t, tq.QuadTable):
            slots.update(tq.sample_table_small_plain(t, u, v))
        elif isinstance(t, tq.MipBlockMulti):
            slots.update(tq.sample_mip_block(t, mat_id, u, v, tile_h,
                                             tile_w))
        else:
            idx, tx, ty = tq.small_footprint_multi(t, mat_id, u, v)
            slots.update(tq.sample_rows_small_plain(t.quads, idx, tx, ty,
                                                    t.present))
    return slots


def shade_sampled_plain(tables, u, v, world, normal, tangent, valid,
                        lights: Lights, view_pos, enable_normal_map,
                        quantize: bool = True, vis_plane=None,
                        vis_light: int = -1, mat_id=None,
                        tile_h: int = 8, tile_w: int = 128,
                        quantize_hdr: bool = False, tonemap: bool = False,
                        enable_tone_mapping=None, exposure=None):
    """Plain version of K2 → (r, g, b) masked HDR planes (LDR after
    :func:`hdr_tail` with ``quantize_hdr`` / ``tonemap``)."""
    if not sampled_groups_supported(tables):
        raise NotImplementedError("shade_sampled: material groups "
                                  f"{[type(t).__name__ for t in tables]}")
    slots = _sample_groups_plain(tables, u, v, mat_id, tile_h, tile_w)
    zero = torch.zeros_like(u)
    for s in tq.SLOTS:
        slots.setdefault(s, zero)
    albedo = (slots["alb_r"], slots["alb_g"], slots["alb_b"])
    nrm = apply_normal_map(normal, tangent,
                           (slots["nrm_x"], slots["nrm_y"], slots["nrm_z"]),
                           enable_normal_map)

    def mq(x):  # the deferred G-buffer: cleared at misses, fp16
        x = torch.where(valid, x, zero)
        return q16(x) if quantize else x

    world_q = tuple(mq(c) for c in world)
    nrm_q = tuple(mq(c) for c in nrm)
    alb_q = tuple(mq(c) for c in albedo)
    met_q, rough_q, ao_q = (mq(slots["metallic"]), mq(slots["roughness"]),
                            mq(slots["ao"]))
    n3 = normalize3(nrm_q)
    v3 = normalize3(tuple(view_pos[c] - world_q[c] for c in range(3)))
    f0 = tuple(0.04 * (1.0 - met_q) + alb_q[c] * met_q for c in range(3))
    lo = ggx_light_sum(lights, world_q, n3, v3, alb_q, f0, met_q, rough_q,
                       _light_vis(vis_plane, vis_light))
    hdr = tuple(0.03 * alb_q[c] * ao_q + lo[c] for c in range(3))
    return hdr_tail(tuple(torch.where(valid, c, zero) for c in hdr),
                    quantize_hdr, tonemap, enable_tone_mapping, exposure)


def _groups(tables, u, v, mat_id, tile_h, tile_w) -> tuple:
    """K2's sampling groups → (Groups, the per-pixel plane tensors it
    points into, kept alive until the launch)."""
    G = _build.Groups
    g = G()
    g.n = len(tables)
    keep = []
    for k, t in enumerate(tables):
        tab = t.blocks if isinstance(t, (tq.BlockTable, tq.MipBlockMulti)) \
            else t.quads
        tq._check_table("shade_sampled", tab, u.device)
        if tab.data_ptr() % _TABLE_ALIGN:
            raise ValueError("shade_sampled: tables must start on a "
                             f"{_TABLE_ALIGN}-byte boundary")
        cpad = tq._ceil4(len(t.present))
        if isinstance(t, tq.BlockTable):
            if t.height % tq.BLOCK_B or t.width % tq.BLOCK_B:
                raise ValueError("block tables need B-divisible sizes")
            if tab.shape[1] < 25 * cpad:
                raise ValueError("block table rows too short")
            g.kind[k] = G.BLOCK
            g.h[k], g.w[k] = t.height, t.width
        elif isinstance(t, tq.MipBlockMulti):
            cpad = len(t.present)
            if tab.shape[1] < tq.MB_TAPS * cpad:
                raise ValueError("mip block rows too short")
            g.kind[k] = G.MIP_BLOCK
            gi, gf = tq.mip_geometry_planes(tq._mip_block_geometry(
                t, mat_id, u, v, tile_h, tile_w))
        else:
            if tab.shape[1] != 4 * cpad:
                raise ValueError("quad table rows must hold 4·cpad bytes")
            if isinstance(t, tq.QuadTable):
                g.kind[k] = G.QUAD
                g.h[k], g.w[k] = t.height, t.width
            else:
                g.kind[k] = G.ROUTED_QUAD
                idx, tx, ty = tq.small_footprint_multi(t, mat_id, u, v)
                gi = idx.reshape(1, -1).contiguous()
                gf = torch.stack([tx.reshape(-1), ty.reshape(-1)])
        if g.kind[k] in (G.MIP_BLOCK, G.ROUTED_QUAD):
            g.gi[k], g.gf[k] = gi.data_ptr(), gf.data_ptr()
            keep += [gi, gf]
        elif tab.shape[1] % _TABLE_ALIGN:
            raise ValueError("shade_sampled: table rows must be a multiple "
                             f"of {_TABLE_ALIGN} bytes")
        g.tab[k] = tab.data_ptr()
        g.rows[k], g.row_bytes[k] = tab.shape
        g.cpad[k] = cpad
        g.n_present[k] = len(t.present)
        for j, s in enumerate(t.present):
            g.slot[k][j] = tq.SLOTS.index(s)
    return g, keep


def _check_planes(fn: str, names, planes, valid, shape, dev) -> None:
    """Every plane a contiguous float32 ``shape`` tensor on ``dev``;
    ``valid`` a bool plane of that shape."""
    for name, t in zip(names, planes):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"{fn}: plane {name} must be a contiguous "
                             f"float32 {tuple(shape)} tensor on {dev}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(shape) \
            or valid.device != dev or not valid.is_contiguous():
        raise ValueError(f"{fn}: valid must be a contiguous bool plane")


def _optional_ptr(t):
    return None if t is None else _build.ptr(t)


def _tail_scalars(dev, tonemap: bool, enable_tone_mapping, exposure):
    """(exposure float32, tone-map enable int32) device scalars for a
    kernel's tone-map epilogue, or (None, None) without one."""
    if not tonemap:
        return None, None
    if enable_tone_mapping is None or exposure is None:
        raise ValueError("tonemap needs enable_tone_mapping and exposure")
    return (exposure.to(device=dev, dtype=torch.float32).reshape(1)
            .contiguous(),
            enable_tone_mapping.to(device=dev, dtype=torch.int32).reshape(1)
            .contiguous())


def shade_sampled(tables, u, v, world, normal, tangent, valid,
                  lights: Lights, view_pos, enable_normal_map,
                  quantize: bool = True, vis_plane=None, vis_light: int = -1,
                  mat_id=None, tile_h: int = 8, tile_w: int = 128,
                  quantize_hdr: bool = False, tonemap: bool = False,
                  enable_tone_mapping=None, exposure=None,
                  generic: bool = False):
    """K2 wrapper. ``tables``: a binding :func:`sampled_groups_supported`
    accepts; pixel args (NT, tile_h·tile_w) float32 planes, ``valid``
    bool; ``view_pos`` (3,) float32; ``enable_normal_map`` a 0-dim int
    tensor; ``vis_plane`` an optional [0, 1] plane scaling the radiance of
    light ``vis_light``; ``mat_id`` the int32 material-id plane that
    routes merged mip groups (None: material 0); ``quantize_hdr`` /
    ``tonemap`` (with the 0-dim ``enable_tone_mapping`` and ``exposure``)
    run :func:`hdr_tail` in the kernel; ``generic`` runs the kernel's
    generic instantiation in place of the one compiled for the binding's
    group layout, if there is one (tests and measurement; same output).
    Returns (r, g, b)."""
    dev = u.device
    shape = u.shape
    planes = [u, v, *world, *normal, *tangent]
    names = ["u", "v", "wx", "wy", "wz", "nx", "ny", "nz", "tx", "ty", "tz"]
    if vis_plane is not None:
        planes.append(vis_plane)
        names.append("vis")
    _check_planes("shade_sampled", names, planes, valid, shape, dev)
    tq._check_mat("shade_sampled", mat_id, u)
    if not sampled_groups_supported(tables):
        raise NotImplementedError("shade_sampled: material groups "
                                  f"{[type(t).__name__ for t in tables]}")
    if any(isinstance(t, tq.MipBlockMulti) for t in tables) and (
            u.ndim != 2 or u.shape[1] != tile_h * tile_w):
        raise ValueError("shade_sampled: mip groups need (NT, "
                         "tile_h·tile_w) tiled planes")
    if dev.type == "cpu":
        return shade_sampled_plain(tables, u, v, world, normal, tangent,
                                   valid, lights, view_pos,
                                   enable_normal_map, quantize,
                                   vis_plane, vis_light, mat_id, tile_h,
                                   tile_w, quantize_hdr, tonemap,
                                   enable_tone_mapping, exposure)
    if dev.type != "cuda":
        raise RuntimeError(f"shade_sampled: unsupported device {dev}")
    groups, keep = _groups(tables, u, v, mat_id, tile_h, tile_w)
    lparams = pack_lights(lights, vis_light)
    vp = view_pos.to(device=dev, dtype=torch.float32).reshape(3).contiguous()
    nm = enable_normal_map.to(device=dev, dtype=torch.int32).reshape(
        1).contiguous()
    expo, tm = _tail_scalars(dev, tonemap, enable_tone_mapping, exposure)
    out = torch.empty((3,) + tuple(shape), dtype=torch.float32, device=dev)
    p = _build.ptr
    n = u.numel()
    # The kernel reads the bool plane's bytes as they are.
    err = _build.library().bb_shade(
        ctypes.byref(groups), *(p(t) for t in planes[:11]), p(valid),
        _optional_ptr(vis_plane), p(lparams), lights.num_lights, p(vp),
        p(nm), int(quantize), _optional_ptr(expo), _optional_ptr(tm),
        int(quantize_hdr), int(tonemap), int(generic), n, p(out[0]),
        p(out[1]), p(out[2]), _build.stream_ptr(dev))
    _build.check(err, "shade")
    shade_sampled.launches += 1
    return out[0], out[1], out[2]


shade_sampled.launches = 0


def shade_tonemap_plain(world, normal, albedo, metallic, roughness, ao,
                        valid, lights: Lights, view_pos, enable_tone_mapping,
                        exposure, vis_plane=None, vis_light: int = -1,
                        ambient=None, quantize: bool = True,
                        tonemap: bool = True):
    """Plain version of K5 → (r, g, b): GGX over G-buffer planes, masked
    by ``valid``, then the optional fp16 round trip and exposure tone
    map."""
    hdr = shade_pbr_planar(world, normal, albedo, metallic, roughness, ao,
                           lights, view_pos,
                           light_vis=_light_vis(vis_plane, vis_light),
                           ambient=ambient)
    zero = torch.zeros_like(metallic)
    return hdr_tail(tuple(torch.where(valid, c, zero) for c in hdr),
                    quantize, tonemap, enable_tone_mapping, exposure)


def shade_tonemap(world, normal, albedo, metallic, roughness, ao, valid,
                  lights: Lights, view_pos, enable_tone_mapping, exposure,
                  vis_plane=None, vis_light: int = -1, ambient=None,
                  quantize: bool = True, tonemap: bool = True):
    """K5 wrapper. Pixel args are (NT, NPX) float32 planes (``valid``
    bool); ``view_pos`` (3,), ``exposure`` and ``enable_tone_mapping``
    0-dim tensors; ``vis_plane`` an optional visibility plane for light
    ``vis_light``; ``ambient`` optional (r, g, b) planes replacing
    0.03·albedo·ao. Returns (r, g, b)."""
    dev = metallic.device
    shape = metallic.shape
    planes = [*world, *normal, *albedo, metallic, roughness, ao]
    names = ["wx", "wy", "wz", "nx", "ny", "nz", "ar", "ag", "ab",
             "metallic", "roughness", "ao"]
    if vis_plane is not None:
        planes.append(vis_plane)
        names.append("vis")
    if ambient is not None:
        planes.extend(ambient)
        names.extend(["amb_r", "amb_g", "amb_b"])
    _check_planes("shade_tonemap", names, planes, valid, shape, dev)
    if dev.type == "cpu":
        return shade_tonemap_plain(
            world, normal, albedo, metallic, roughness, ao, valid, lights,
            view_pos, enable_tone_mapping, exposure, vis_plane, vis_light,
            ambient, quantize, tonemap)
    if dev.type != "cuda":
        raise RuntimeError(f"shade_tonemap: unsupported device {dev}")
    lparams = pack_lights(lights, vis_light)

    def scalar(x, dtype, n=1):
        return x.to(device=dev, dtype=dtype).reshape(n).contiguous()

    vp = scalar(view_pos, torch.float32, 3)
    expo = scalar(exposure, torch.float32)
    tm = scalar(enable_tone_mapping, torch.int32)
    amb = ambient if ambient is not None else (None, None, None)
    out = torch.empty((3,) + tuple(shape), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.library().bb_shade_gbuffer(
        *(p(t) for t in planes[:12]), p(valid), _optional_ptr(vis_plane),
        *(_optional_ptr(a) for a in amb), p(lparams), lights.num_lights,
        p(vp), p(expo), p(tm), int(quantize), int(tonemap),
        metallic.numel(), p(out[0]), p(out[1]), p(out[2]),
        _build.stream_ptr(dev))
    _build.check(err, "shade_gbuffer")
    shade_tonemap.launches += 1
    return out[0], out[1], out[2]


shade_tonemap.launches = 0
