"""The application frame loop (port of ``bibim_tpu.host.app``) — the
main.cpp analog, headless.

Replaces the SDL window + ImGui GUI with a CLI: scene selection
(main.cpp:1157-1182), render settings (forward/deferred, G-buffer
visualization, main.cpp:1186-1226), the Settings toggles (normal map / tone
mapping / TBN / exposure, main.cpp:1302-1316), free-look camera driven by a
scripted orbit or explicit pose (mouse/WASD analog, main.cpp:1237-1262), and
PNG frames instead of a swapchain present. ``--events`` replays an event
script through :class:`~bibim_tpu_torch.host.session.Session`, ``--serve``
starts the live viewer (:mod:`bibim_tpu_torch.host.serve`).

The frames render on ``--device`` (default ``cuda``: the card; ``cpu``
runs the kernels' plain versions). They render with
``outputs="image"``, the production path through the kernels; the JAX
package's app asks for the default ``"full"``, which adds debug planes it
never reads and shades through the plain chain.

Usage:
    python -m bibim_tpu_torch.host.app --scene shaderball --size 1280 720 \
        --out frame.png [--frames N] [--orbit] [--material 1] ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.assets.image import save_png
from bibim_tpu_torch.assets.materials import create_pbr_material_set
from bibim_tpu_torch.host.readback import DoubleBufferedReadback
from bibim_tpu_torch.host.session import VIZ_BY_NAME, upload
from bibim_tpu_torch.pipeline import (
    FrameParams,
    RenderSettings,
    ViewBlock,
    make_overlay_resources,
    material_quads_from_set,
    render_frame,
)
from bibim_tpu_torch.scene.camera import FreeLookCamera
from bibim_tpu_torch.scene.gizmoscene import (
    GIZMO_CAMERA_DISTANCE,
    GIZMO_FOV_DEGREES,
    GizmoScene,
)
from bibim_tpu_torch.scene.shaderball import ShaderBallScene
from bibim_tpu_torch.scene.triangle import TriangleScene
from bibim_tpu_torch.utils import profiling
from bibim_tpu_torch.utils.log import log_info
from bibim_tpu_torch.utils.profiling import FrameStats
from bibim_tpu_torch.utils.timing import Stopwatch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="bibim_tpu_torch renderer")
    p.add_argument("--scene",
                   choices=["triangle", "shaderball", "gizmo", "cube", "mesh"],
                   default="shaderball")
    p.add_argument("--mesh-path", default=None,
                   help="OBJ/FBX file for --scene mesh (bring your own asset)")
    p.add_argument("--no-mips", action="store_true",
                   help="level-0 sampling only (reference parity) for cube scene")
    p.add_argument("--size", nargs=2, type=int, default=[1280, 720],
                   metavar=("W", "H"))
    p.add_argument("--out", default="bibim_frame.png")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera over the frames")
    p.add_argument("--spin", action="store_true", help="spin shader balls 30°/s")
    p.add_argument("--instances", type=int, default=1)
    p.add_argument("--material", type=int, default=None)
    p.add_argument("--camera", nargs=5, type=float, default=None,
                   metavar=("X", "Y", "Z", "YAW", "PITCH"))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--forward", action="store_true",
                   help="forward lighting path instead of deferred")
    p.add_argument("--viz", choices=sorted(VIZ_BY_NAME), default="scene")
    p.add_argument("--normal-map", action="store_true")
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--tbn", action="store_true")
    p.add_argument("--hud", action="store_true",
                   help="burn an FPS/camera stats line into the frame "
                        "(ImGui-overlay analog)")
    p.add_argument("--no-gizmo", action="store_true")
    p.add_argument("--no-lights", action="store_true")
    p.add_argument("--no-srgb", action="store_true")
    p.add_argument("--aniso", type=int, default=1, metavar="N",
                   help="N-tap in-level-0 anisotropic sampling (the "
                   "reference sampler's maxAnisotropy analog; 1 = plain "
                   "bilinear parity)")
    p.add_argument("--pair-sampling", type=int, default=0, choices=(0, 1, 2),
                   metavar="L",
                   help="group-rate block-table sampling: one texture-row "
                        "gather per 2x1 (1) / 2x2 (2) pixel group, with "
                        "exact per-tile routing — bit-identical output")
    p.add_argument("--shadows", action="store_true",
                   help="shadow-map the first light (stretch capability)")
    p.add_argument("--ibl", action="store_true",
                   help="procedural-sky split-sum IBL ambient (stretch)")
    p.add_argument("--ibl-tables", action="store_true",
                   help="use the equirect-table IBL path instead of the "
                        "analytic SphPoly+SG fit (oracle/debug)")
    p.add_argument("--no-write", action="store_true",
                   help="render without PNG output or full-frame egress "
                        "(sustained render-loop throughput; frames sync "
                        "on one dependent pixel)")
    p.add_argument("--cull", action="store_true",
                   help="host frustum-culling of the ShaderBall instances "
                        "each frame (power-of-two buckets; skip with "
                        "--shadows - off-screen casters still shadow the "
                        "view)")
    p.add_argument("--max-candidates", type=int, default=None,
                   help="per-tile raster capacity override")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="live viewer: serve an MJPEG stream + browser "
                        "event capture on http://localhost:PORT/ (the "
                        "reference's window + present loop, "
                        "main.cpp:192-196, 1367-1380)")
    p.add_argument("--events", default=None,
                   help="JSON event script: run an interactive session "
                        "replay (see host/session.py) instead of the "
                        "scripted camera")
    p.add_argument("--list-materials", action="store_true")
    p.add_argument("--material-previews", default=None, metavar="PNG",
                   help="write a material-map contact sheet and exit")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the frames render (cpu: the kernels' plain "
                        "versions)")
    p.add_argument("--no-spans", action="store_true",
                   help="switch the host span recorder off "
                        "(utils/profiling.py; /stats then has no stage "
                        "times)")
    return p


def make_scene(args, device="cuda"):
    if args.scene == "triangle":
        return TriangleScene(device=device)
    if args.scene == "gizmo":
        return GizmoScene(device=device)
    if args.scene == "mesh":
        from bibim_tpu_torch.scene.meshscene import MeshScene

        if not args.mesh_path:
            raise SystemExit("--scene mesh requires --mesh-path FILE.obj/.fbx")
        return MeshScene(path=args.mesh_path, spin=args.spin, device=device)
    if args.scene == "cube":
        from bibim_tpu_torch.scene.cube import CubeScene

        return CubeScene(spin=args.spin, device=device)
    return ShaderBallScene(num_instances=args.instances, spin=args.spin,
                           device=device)


def default_camera(args) -> FreeLookCamera:
    cam = FreeLookCamera()
    if args.camera is not None:
        cam.pos = np.asarray(args.camera[:3], np.float32)
        cam.yaw, cam.pitch = args.camera[3], args.camera[4]
    elif args.scene == "gizmo":
        cam.pos = np.asarray([0, 0, -GIZMO_CAMERA_DISTANCE], np.float32)
    return cam


def frame_settings(args, scene) -> RenderSettings:
    """The CLI frame's settings (the capacities the defaults, or
    ``--max-candidates``)."""
    width, height = args.size
    return RenderSettings(
        width=width,
        height=height,
        deferred=not args.forward,
        shading="flat" if args.scene == "gizmo" else "pbr",
        gbuffer_viz=VIZ_BY_NAME[args.viz],
        show_lights=not args.no_lights,
        show_gizmo=not args.no_gizmo,
        show_tbn=args.tbn,
        show_hud=args.hud,
        srgb_output=not args.no_srgb,
        # Same clamp as UiState (1..16).
        aniso_taps=max(1, min(16, args.aniso)),
        pair_sampling=args.pair_sampling,
        enable_shadows=args.shadows,
        shadow_fit_batches=(getattr(scene, "shadow_fit_batches", None)
                            if args.shadows else None),
        enable_ibl=args.ibl,
        batch_material_ids=getattr(scene, "material_ids", None),
        outputs="image",
        **({"max_candidates": args.max_candidates}
           if args.max_candidates else {}),
    )


def _run_session(args, device) -> int:
    from bibim_tpu_torch.host.gui import UiState
    from bibim_tpu_torch.host.session import Session

    width, height = args.size
    ui = UiState(scene=args.scene, enable_tone_mapping=not args.no_tonemap,
                 exposure=args.exposure, enable_tbn=args.tbn,
                 enable_normal_map=args.normal_map,
                 num_instances=args.instances,
                 aniso_taps=max(1, args.aniso),
                 mesh_path=args.mesh_path or "")
    if args.material is not None:
        ui.selected_material = args.material
    session = Session(width=width, height=height, ui=ui, device=device)
    if args.serve is not None:
        from bibim_tpu_torch.host.serve import ViewerServer

        ViewerServer(session, host="0.0.0.0",
                     port=args.serve).start().serve_until_interrupt()
        return 0
    written = 0
    for img in session.run_script(args.events, args.frames):
        path = (args.out if args.frames == 1
                else args.out.replace(".png", f"_{written:04d}.png"))
        save_png(path, img)
        written += 1
    log_info("session replay: {} frame(s), avg {:.1f} ms/frame",
             written, session.stats.ms_per_frame)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    profiling.set_enabled(not args.no_spans)
    device = torch.device(args.device)
    width, height = args.size

    if args.list_materials:
        ms = create_pbr_material_set()
        for i, name in enumerate(ms.names):
            print(f"{i}: {name}")
        return 0
    if args.material_previews:
        from bibim_tpu_torch.host.session import save_material_previews

        save_material_previews(create_pbr_material_set(),
                               args.material_previews)
        return 0
    if args.events or args.serve is not None:
        return _run_session(args, device)

    scene = make_scene(args, device)
    cam = default_camera(args)
    fov = (GIZMO_FOV_DEGREES if (args.scene == "gizmo"
                                 and args.camera is None) else args.fov)
    settings = frame_settings(args, scene)

    if args.scene == "cube":
        from bibim_tpu_torch.scene.cube import cube_scene_materials

        mats = cube_scene_materials(device=device,
                                    with_mips=not args.no_mips)
    else:
        mat_index = (args.material if args.material is not None
                     else scene.selected_material)
        mats = material_quads_from_set(create_pbr_material_set(), mat_index,
                                       device=device)
    overlay = make_overlay_resources(device=device)

    proj_host = m3.perspective(fov, width / height, 0.1, 1000.0,
                               device="cpu")
    proj = upload(proj_host, torch.float32, device)
    frame_params = FrameParams(
        enable_tone_mapping=upload(0 if args.no_tonemap else 1, torch.int32,
                                   device),
        exposure=upload(args.exposure, torch.float32, device),
    )

    if args.shadows:
        # The shadow pass assumes a directional caster (orthographic light
        # frustum); reject other light types up front instead of rendering
        # garbage visibility.
        lt = int(scene.scene_data().lights.type[0])
        if lt != 2:
            raise SystemExit(
                "--shadows requires light 0 to be directional "
                f"(scene light 0 has type {lt})"
            )
    cull = args.cull and not args.shadows
    if cull and not hasattr(scene, "culled_scene_data"):
        raise SystemExit("--cull culls the ShaderBall scene's instances "
                         f"(scene {args.scene!r} keeps no host instances)")

    ibl_maps = None
    if args.ibl:
        from bibim_tpu_torch.ops.ibl import make_ibl, make_ibl_sh

        ibl_maps = (make_ibl(device=device) if args.ibl_tables
                    else make_ibl_sh(device=device))

    readback = DoubleBufferedReadback(depth=2)
    clock = Stopwatch()
    stats = FrameStats()
    written = 0

    hud_geom = None
    if args.hud:
        from bibim_tpu_torch.host.hud import build_hud_geometry

        hud_geom = build_hud_geometry(width, height)

    def hud_payload():
        if hud_geom is None:
            return None
        from bibim_tpu_torch.host.hud import hud_text_mask

        text = (f"{stats.fps:5.1f} FPS  POS {cam.pos[0]:.1f} "
                f"{cam.pos[1]:.1f} {cam.pos[2]:.1f}  YAW {cam.yaw:.0f} "
                f"PITCH {cam.pitch:.0f}")
        return (hud_geom, upload(hud_text_mask(text, hud_geom.max_chars),
                                 torch.float32, device))

    def write(img: np.ndarray | None):
        nonlocal written
        if img is None:
            return
        path = (args.out if args.frames == 1
                else args.out.replace(".png", f"_{written:04d}.png"))
        save_png(path, img)
        written += 1

    for frame in range(args.frames):
        dt = clock.tick()
        if args.orbit and args.frames > 1:
            cam.yaw = 360.0 * frame / args.frames
            look = cam.get_look()
            center = np.asarray([0.0, 0.0, 2.0], np.float32)
            cam.pos = center - look * 6.0
        scene.update_scene(dt)

        view = cam.get_view_matrix()
        view_block = ViewBlock(
            view=upload(view, torch.float32, device),
            proj=proj,
            view_pos=upload(cam.pos, torch.float32, device),
            enable_normal_map=upload(1 if args.normal_map else 0,
                                     torch.int32, device),
        )
        data = (scene.culled_scene_data(view, proj_host.numpy()) if cull
                else scene.scene_data())
        out = render_frame(data, view_block, frame_params, mats, overlay,
                           settings, ibl=ibl_maps, hud=hud_payload())
        if args.no_write:
            # Sustained render-loop throughput: sync on one dependent
            # pixel, no full-frame egress.
            out["image"][:1, :1, :1].cpu()
            written += 1
        else:
            write(readback.submit(out["image"]))
        stats.tick()

    for img in readback.flush():
        write(img)
    if args.no_write and args.frames > 1:
        log_info("sustained loop: {:.2f} ms/frame ({:.1f} fps) over {} "
                 "frames", stats.ms_per_frame, stats.fps, written)
        return 0
    log_info("wrote {} frame(s) to {}", written, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
