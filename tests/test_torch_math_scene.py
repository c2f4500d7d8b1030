"""Port math and scene data vs the JAX package: host-built arrays (meshes,
draw batches, corner planes, lights, camera, instance matrices) bit-equal;
device math within a few float32 ulps (XLA contracts a*b+c into FMAs on
the CPU, the port rounds each operation); and the port's import and CPU
frame load neither jax nor the JAX package."""

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bibim_tpu import math3d as jm3
from bibim_tpu.assets import meshgen as jmeshgen
from bibim_tpu.ops.geometry import assemble_scene_planar as j_assemble
from bibim_tpu.scene.camera import FreeLookCamera as JCamera
from bibim_tpu.scene.scene import batch_from_mesh as j_batch_from_mesh
from bibim_tpu.scene import shaderball as jshaderball
from bibim_tpu_torch import interop
from bibim_tpu_torch import math3d as m3
from bibim_tpu_torch.ops.geometry import assemble_scene_planar
from bibim_tpu_torch.scene import meshgen, shaderball
from bibim_tpu_torch.scene.camera import FreeLookCamera
from bibim_tpu_torch.scene.scene import batch_from_mesh
from tests import torch_port_cases as cases


@pytest.fixture(autouse=True, scope="module")
def _threads():
    cases.cap_threads()


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for c in x for y in _leaves(c)]
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    return [x]


@pytest.mark.parametrize("args", [(1.0, 24, 16), (100.0, 100, 51),
                                  (0.1, 16, 16)])
def test_uv_sphere_bit_equal(args):
    want = jmeshgen.generate_uv_sphere_mesh(*args)
    got = meshgen.generate_uv_sphere_mesh(*args)
    for f in ("positions", "uvs", "normals", "tangents", "indices"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_batch_from_mesh_bit_equal():
    mesh = meshgen.generate_uv_sphere_mesh(1.0, 12, 8)
    model = np.asarray(jm3.translate([0.5, -1.0, 4.0]))
    want = interop.draw_batch(j_batch_from_mesh(
        jmeshgen.generate_uv_sphere_mesh(1.0, 12, 8), model))
    got = batch_from_mesh(mesh, model)
    for f in ("positions", "uvs", "normals", "tangents", "colors", "indices",
              "model", "inv_model"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    assert sorted(got.corner_planes) == sorted(want.corner_planes)
    for a, b in zip(_leaves(got.corner_planes),
                    _leaves(want.corner_planes)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_lights_and_instances_bit_equal():
    want = interop.lights(jshaderball.shaderball_lights())
    got = shaderball.shaderball_lights()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jm, jinv = jshaderball.shaderball_instance_matrices(3, -90.0)
    m, inv = shaderball.shaderball_instance_matrices(3, -90.0)
    np.testing.assert_array_equal(m, np.asarray(jm))
    np.testing.assert_array_equal(inv, np.asarray(jinv))


def test_camera_bit_equal():
    for yaw, pitch in ((0.0, 0.0), (-75.0, 10.0), (33.0, -20.0)):
        pos = np.asarray([0.3, 1.0, -2.0], np.float32)
        a = FreeLookCamera(pos=pos, yaw=yaw, pitch=pitch)
        b = JCamera(pos=pos, yaw=yaw, pitch=pitch)
        np.testing.assert_array_equal(a.get_view_matrix(),
                                      b.get_view_matrix())
        a.apply_mouse_drag(4.0, -3.0)
        b.apply_mouse_drag(4.0, -3.0)
        a.apply_movement(1, -1, 0.1)
        b.apply_movement(1, -1, 0.1)
        np.testing.assert_array_equal(a.pos, b.pos)


def test_matrix_constructors():
    pairs = [
        (m3.perspective(60.0, 2.0, 0.1, 1000.0),
         jm3.perspective(60.0, 2.0, 0.1, 1000.0)),
        (m3.look_at([1.0, 2.0, -3.0], [0.0, 0.5, 2.0]),
         jm3.look_at([1.0, 2.0, -3.0], [0.0, 0.5, 2.0])),
        (m3.translate([1.0, -2.0, 3.5]), jm3.translate([1.0, -2.0, 3.5])),
        (m3.scale(2.5), jm3.scale(2.5)),
        (m3.scale([1.0, 2.0, 3.0]), jm3.scale([1.0, 2.0, 3.0])),
        (m3.rotate_x(30.0), jm3.rotate_x(30.0)),
        (m3.rotate_y(-75.0), jm3.rotate_y(-75.0)),
        (m3.rotate_z(120.0), jm3.rotate_z(120.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=3e-7, atol=1e-7)
    a = np.asarray(jm3.compose(jm3.translate([1.0, 2.0, 3.0]),
                               jm3.rotate_y(40.0), jm3.scale(0.5)))
    b = np.asarray(jm3.rotate_x(-20.0))
    np.testing.assert_array_equal(m3.matmul(cases.t(a), cases.t(b)).numpy(),
                                  np.asarray(jm3.matmul(a, b)))
    np.testing.assert_allclose(m3.inverse(cases.t(a)).numpy(),
                               np.asarray(jm3.inverse(a)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(m3.normal_matrix(cases.t(a)).numpy(),
                                  np.asarray(jm3.normal_matrix(a)))


def test_assemble_scene_planar_matches_jax():
    scene, view, proj = cases.jax_scene()
    want = j_assemble(scene.batches, view, proj)
    got = assemble_scene_planar(interop.scene_data(scene).batches,
                                cases.t(view), cases.t(proj))
    for f in ("uv", "color", "mat"):
        for a, b in zip(_leaves(getattr(got, f)), _leaves(getattr(want, f))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("clip", "world", "normal", "tangent"):
        for a, b in zip(_leaves(getattr(got, f)), _leaves(getattr(want, f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=f)


def test_port_runs_without_jax():
    """Importing the port and rendering a small CPU frame from the port's
    own scene pieces loads neither jax nor the JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import bibim_tpu_torch
        from bibim_tpu_torch import math3d as m3
        from bibim_tpu_torch.ops import texture_quad as tq
        from bibim_tpu_torch.pipeline import (
            FrameParams, RenderSettings, ViewBlock, make_overlay_resources,
            render_frame)
        from bibim_tpu_torch.scene import FreeLookCamera, TriangleScene
        from bibim_tpu_torch.utils.validation import check_bin_diag

        torch.set_num_threads(1)
        rng = np.random.default_rng(0)
        maps = {s: rng.integers(0, 256, (16, 16, 1), dtype=np.uint8)
                for s in tq.SLOTS}
        cam = FreeLookCamera()
        vb = ViewBlock(view=torch.as_tensor(cam.get_view_matrix()),
                       proj=m3.perspective(60.0, 2.0, 0.1, 1000.0),
                       view_pos=torch.as_tensor(cam.pos),
                       enable_normal_map=torch.tensor(1))
        fp = FrameParams(torch.tensor(1), torch.tensor(1.0))
        out = render_frame(
            TriangleScene().scene_data(), vb, fp, tq.build_quad_tables(maps),
            make_overlay_resources(with_gizmo=False),
            RenderSettings(width=128, height=64, show_gizmo=False,
                           outputs="image+diag"))
        check_bin_diag(out["bin_diag"])
        assert out["image"].shape == (64, 128, 3)
        assert int(out["image"].sum()) > 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "bibim_tpu.")))
        assert "bibim_tpu" not in sys.modules and not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr
