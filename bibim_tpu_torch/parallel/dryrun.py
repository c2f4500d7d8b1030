"""The sharded frame's dry run (the port's counterpart of the JAX
package's ``dryrun_multichip``): a :class:`ShardedRenderer` over ``n``
bands on the ShaderBall scene of the resource root, 960 × (64·n), with
deferred PBR, a 128² shadow map, analytic IBL, pair sampling asked for,
light spheres and the corner gizmo, at margin 1.05. The first frame looks
away from the scene, so its probe derives near-empty band caps; the
second faces the scene, drops geometry, and must re-probe and render
again.

Run on the card: ``python -m bibim_tpu_torch.parallel.dryrun 4`` (four
bands in one process), or one band per rank:
``torchrun --nproc-per-node 4 -m bibim_tpu_torch.parallel.dryrun``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from bibim_tpu_torch.pipeline.framegraph import KERNELS, Kernels


def _inputs(width: int, height: int, cam, device):
    from bibim_tpu_torch import math3d as m3
    from bibim_tpu_torch.pipeline import FrameParams, ViewBlock

    view_block = ViewBlock(
        view=torch.as_tensor(cam.get_view_matrix(), device=device),
        proj=m3.perspective(60.0, width / height, 0.1, 1000.0,
                            device=device),
        view_pos=torch.as_tensor(np.asarray(cam.pos), device=device),
        enable_normal_map=torch.tensor(0, dtype=torch.int32, device=device))
    frame_params = FrameParams(
        enable_tone_mapping=torch.tensor(1, dtype=torch.int32,
                                         device=device),
        exposure=torch.tensor(1.0, dtype=torch.float32, device=device))
    return view_block, frame_params


def dryrun_multichip(n_devices: int, device="cuda",
                     kernels: Kernels = KERNELS, mesh=None):
    """Render the away frame, then the front frame, through one
    ShardedRenderer over ``n_devices`` bands (``make_device_mesh``, or
    ``mesh``); raises unless the first frame tuned once and the second
    re-probed. Returns (the renderer, (away image, front image))."""
    from bibim_tpu_torch.assets.materials import create_pbr_material_set
    from bibim_tpu_torch.ops.ibl import make_ibl_sh
    from bibim_tpu_torch.parallel import ShardedRenderer, make_device_mesh
    from bibim_tpu_torch.pipeline import (
        RenderSettings,
        make_overlay_resources,
        material_quads_from_set,
    )
    from bibim_tpu_torch.scene.camera import FreeLookCamera
    from bibim_tpu_torch.scene.shaderball import ShaderBallScene

    width, height = 960, 64 * n_devices
    settings = RenderSettings(
        width=width, height=height, enable_shadows=True, shadow_size=128,
        shadow_candidates=16384, enable_ibl=True, pair_sampling=2)
    scene = ShaderBallScene(device=device)
    mats = material_quads_from_set(create_pbr_material_set(),
                                   scene.selected_material, device=device)
    # 180° of yaw: the scene is behind the camera.
    away = FreeLookCamera()
    away.apply_mouse_drag(300, 0)
    vb_away, fp = _inputs(width, height, away, device)
    vb_front, _ = _inputs(width, height, FreeLookCamera(), device)
    if mesh is None:
        mesh = make_device_mesh(n_devices, device=device)
    renderer = ShardedRenderer(
        mesh, settings, mats,
        overlay=make_overlay_resources(device=device),
        ibl=make_ibl_sh(device=device), margin=1.05, kernels=kernels)
    data = scene.scene_data()
    img_away = renderer.render(data, vb_away, fp)
    if renderer.retunes != 1:
        raise AssertionError(f"away frame: retunes {renderer.retunes}")
    img_front = renderer.render(data, vb_front, fp)
    if renderer.retunes < 2:
        raise AssertionError("the front frame did not re-probe (retunes "
                             f"{renderer.retunes})")
    for img in (img_away, img_front):
        if tuple(img.shape) != (height, width, 3):
            raise AssertionError(f"dry run image {tuple(img.shape)}")
    return renderer, (img_away, img_front)


def main() -> None:
    import os

    if "WORLD_SIZE" in os.environ:  # started by torchrun: a band a rank
        import torch.distributed as dist

        from bibim_tpu_torch.parallel import make_process_mesh

        mesh = make_process_mesh()
        try:
            r, _ = dryrun_multichip(mesh.n_bands, mesh=mesh)
        finally:
            dist.destroy_process_group()
    else:
        r, _ = dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                                else 4)
    print(f"dry run on {r.mesh.n_bands} bands: retunes {r.retunes}")


if __name__ == "__main__":
    main()
