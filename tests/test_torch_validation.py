"""The validation helpers (``utils.validation``: ``check_scene_data``,
``check_frame_output``, ``validation_layer``) and ``RenderPassType``
against the JAX package's: the same well-formed inputs pass in both, the
same malformed scenes and frame outputs raise in both."""

import dataclasses

import numpy as np
import pytest
import torch

from bibim_tpu.scene.scene import RenderPassType as JaxRenderPassType
from bibim_tpu.utils import validation as jval
from bibim_tpu_torch import interop
from bibim_tpu_torch.parallel import make_device_mesh, render_frame_sharded
from bibim_tpu_torch.pipeline import RenderSettings, render_frame
from bibim_tpu_torch.scene import RenderPassType, SceneBase
from bibim_tpu_torch.utils import validation as pval
from tests import torch_port_cases as cases


@pytest.fixture(scope="module")
def scene():
    """The test scene (sphere over the ground plane, three lights) in
    both packages."""
    jscene, _, _ = cases.jax_scene()
    return jscene, interop.scene_data(jscene, device="cpu")


def _bad_batch(b, kind):
    import jax.numpy as jnp

    if kind == "positions":
        return b._replace(positions=b.positions[:, :2])
    if kind == "uvs":
        return b._replace(uvs=b.uvs[:-1])
    if kind == "indices":
        return b._replace(indices=b.indices.at[0, 0].set(
            b.positions.shape[0]))
    if kind == "model":
        return b._replace(model=jnp.zeros((1, 3, 4), jnp.float32))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["positions", "uvs", "indices", "model",
                                  "lights", "too_many_lights"])
def test_check_scene_data_raises_in_both(scene, kind):
    import jax.numpy as jnp

    jscene, pscene = scene
    jval.check_scene_data(jscene)
    pval.check_scene_data(pscene)
    if kind == "lights":
        bad = jscene._replace(lights=jscene.lights._replace(
            color=jscene.lights.color[:-1]))
    elif kind == "too_many_lights":
        lt = jscene.lights
        bad = jscene._replace(lights=type(lt)(*(
            jnp.concatenate([f] * 40) for f in lt)))
    else:
        b0 = _bad_batch(jscene.batches[0], kind)
        bad = jscene._replace(batches=(b0,) + jscene.batches[1:])
    with pytest.raises(AssertionError):
        jval.check_scene_data(bad)
    with pytest.raises(AssertionError):
        pval.check_scene_data(interop.scene_data(bad, device="cpu"))


def _output(kind):
    rng = np.random.default_rng(3)
    out = {"image": rng.integers(0, 256, (8, 16, 3), dtype=np.uint8),
           "depth": rng.random((8, 16), dtype=np.float32),
           "hdr": rng.random((8, 16, 3), dtype=np.float32)}
    if kind == "nan_hdr":
        out["hdr"][2, 3, 1] = np.nan
    elif kind == "inf_hdr":
        out["hdr"][0, 0, 0] = np.inf
    elif kind == "depth_range":
        out["depth"][1, 1] = 1.5
    elif kind == "nan_depth":
        out["depth"][4, 4] = np.nan
    elif kind == "float_image":
        out["image"] = out["image"].astype(np.float32)
    return out


@pytest.mark.parametrize("kind", ["nan_hdr", "inf_hdr", "depth_range",
                                  "nan_depth", "float_image"])
def test_check_frame_output_raises_in_both(kind):
    good = _output(None)
    jval.check_frame_output(good)
    pval.check_frame_output({k: torch.from_numpy(v)
                             for k, v in good.items()})
    bad = _output(kind)
    with pytest.raises(AssertionError):
        jval.check_frame_output(bad)
    with pytest.raises(AssertionError):
        pval.check_frame_output({k: torch.from_numpy(v)
                                 for k, v in bad.items()})


def test_validation_layer_raises_on_non_finite_hdr():
    """A light of NaN intensity makes the covered pixels' HDR NaN: the
    frame and the sharded frame return without the layer and raise within
    it; a well-formed frame passes within it unchanged."""
    _, pin = cases.shard_inputs()
    s = RenderSettings(width=cases.SHARD_W, height=cases.SHARD_H,
                       outputs="image")
    mesh = make_device_mesh(2, device="cpu")
    with pval.validation_layer():
        assert pval.validation_active()
        ok = render_frame(*pin, None, s)["image"]
        ok_full = render_frame(*pin, None,
                               dataclasses.replace(s, outputs="full"))
        ok_bands = render_frame_sharded(mesh, *pin, s)
    assert not pval.validation_active()
    assert torch.equal(ok, render_frame(*pin, None, s)["image"])
    assert torch.equal(ok_full["image"], ok)
    assert torch.equal(ok_bands, render_frame_sharded(mesh, *pin, s))

    lights = pin[0].lights._replace(
        intensity=torch.full_like(pin[0].lights.intensity, float("nan")))
    bad = (pin[0]._replace(lights=lights),) + tuple(pin[1:])
    render_frame(*bad, None, s)
    render_frame_sharded(mesh, *bad, s)
    with pval.validation_layer():
        for outputs in ("image", "full"):
            with pytest.raises(AssertionError, match="NaN"):
                render_frame(*bad, None,
                             dataclasses.replace(s, outputs=outputs))
        with pytest.raises(AssertionError, match="NaN"):
            render_frame_sharded(mesh, *bad, s)


def test_render_pass_type_matches_jax():
    assert {m.name: int(m) for m in RenderPassType} == {
        m.name: int(m) for m in JaxRenderPassType}
    assert SceneBase().scene_render_pass_type == RenderPassType.DEFERRED
