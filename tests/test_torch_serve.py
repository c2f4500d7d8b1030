"""The port's live viewer (bibim_tpu_torch.host.serve) on the CPU: the JPEG
encode, FrameHub, a ViewerServer on 127.0.0.1 over a CPU session on the
stand-in resource root (every endpoint, events driving the camera, the
event-queue cap, stop with no thread left), and a render loop that raises:
its exception reaches wait_for_frame and stop(). Every wait has its own
timeout of at most 30 s."""

import json
import threading
import urllib.error
import urllib.request
from io import BytesIO

import numpy as np
import pytest
from PIL import Image

from bibim_tpu_torch.host import serve
from bibim_tpu_torch.host.gui import UiState
from bibim_tpu_torch.host.serve import FrameHub, ViewerServer, encode_frame_jpeg
from bibim_tpu_torch.host.session import Session
from tests import torch_port_cases as cases

TIMEOUT = 30


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(BytesIO(data)).convert("RGB"))


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    cases.cap_threads()
    with cases.standin_resources(tmp_path_factory.mktemp("standin"),
                                 with_jax=False) as cfg:
        yield cfg


class TestEncode:
    @pytest.mark.parametrize("native_lib", [True, False])
    def test_jpeg_roundtrip(self, monkeypatch, native_lib):
        from bibim_tpu_torch import native

        if not native_lib:
            monkeypatch.setattr(native, "_lib", lambda: None)
        y, x = np.mgrid[0:64, 0:96]
        img = np.stack([x * 2, y * 3, x + y], -1).astype(np.uint8)
        data = encode_frame_jpeg(img, quality=95)
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        back = _decode(data)
        assert back.shape == img.shape
        assert np.abs(back.astype(int) - img.astype(int)).mean() < 4
        rgba = np.full((16, 16, 4), 128, np.uint8)
        assert encode_frame_jpeg(rgba)[:2] == b"\xff\xd8"


def test_frame_hub_latest_frame_semantics():
    hub = FrameHub()
    seq, data = hub.wait_next(0, timeout=0.01)
    assert data is None and seq == 0
    hub.publish(b"a")
    hub.publish(b"b")
    seq, data = hub.wait_next(0, timeout=0.01)
    assert data == b"b" and seq == 2  # slow client skips, never lags
    seq2, data2 = hub.wait_next(seq, timeout=0.01)
    assert data2 is None and seq2 == seq
    # wake() releases a waiter before its timeout.
    t = threading.Timer(0.05, hub.wake)
    t.start()
    assert hub.wait_next(seq, timeout=TIMEOUT) == (seq, None)
    t.join(TIMEOUT)


# Loopback requests go straight to the viewer, whatever proxy the
# environment names (urlopen would follow http_proxy).
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(viewer, path):
    return _OPENER.open(f"http://127.0.0.1:{viewer.port}{path}",
                        timeout=TIMEOUT)


def _post(viewer, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{viewer.port}/event", data=body, method="POST")
    return _OPENER.open(req, timeout=TIMEOUT)


def _viewer_threads():
    return [t for t in threading.enumerate()
            if t.name in ("bibim-render", "bibim-http")]


class TestViewerServer:
    @pytest.fixture(scope="class")
    def viewer(self, standin):
        ui = UiState(scene="triangle", enable_tone_mapping=True)
        session = Session(width=128, height=64, ui=ui, readback_depth=1,
                          device="cpu")
        v = ViewerServer(session, port=0, max_fps=120).start()
        v.wait_for_frame(TIMEOUT)
        yield v
        v.stop()
        assert not _viewer_threads()

    def test_page_and_frame(self, viewer):
        page = _get(viewer, "/").read().decode()
        assert "<img id=\"view\" src=\"/stream\">" in page
        for ctl in ("exp", "tm", "viz", "scene", "path", "hud", "aniso",
                    "mat"):
            assert f'id="{ctl}"' in page
        r = _get(viewer, "/frame.jpg")
        assert r.headers["Content-Type"] == "image/jpeg"
        assert _decode(r.read()).shape == (64, 128, 3)

    def test_events_drive_the_camera(self, viewer):
        start = viewer.session.camera.pos.copy()
        assert _post(viewer, json.dumps({"key": "w", "down": True})
                     .encode()).status == 200
        seq, _ = viewer.wait_for_frame(TIMEOUT)
        viewer.wait_for_frame(TIMEOUT, after=seq)
        assert _post(viewer, json.dumps([{"key": "w", "down": False}])
                     .encode()).status == 200
        moved = viewer.session.camera.pos
        assert moved[2] > start[2] and moved[0] == start[0]
        ui = json.loads(_get(viewer, "/ui").read())
        assert ui["scene"] == "triangle" and ui["camera_pos"][2] > start[2]

    def test_stats_and_bad_event(self, viewer):
        seq, _ = viewer.wait_for_frame(TIMEOUT)
        viewer.wait_for_frame(TIMEOUT, after=seq)
        stats = json.loads(_get(viewer, "/stats").read())
        assert stats["size"] == [128, 64] and stats["frames"] >= 2
        assert stats["fps"] > 0
        # The render_frame stages' rolling medians, from the span recorder.
        stages = stats["stages"]
        assert set(stages) == {"geometry_ms", "raster_ms", "shade_ms",
                               "overlay_ms", "output_ms", "host_syncs",
                               "raster_tail"}
        assert all(stages[k] > 0 for k in stages
                   if k not in ("host_syncs", "raster_tail"))
        assert stages["host_syncs"] == 0  # a CPU session never syncs
        assert stages["raster_tail"] == 0  # one raster pass a frame
        for body in (b"{not json", b"[1, 2]"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(viewer, body)
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(viewer, "/nope")
        assert err.value.code == 404
        # A well-formed event the session rejects is logged and dropped;
        # the loop keeps rendering.
        _post(viewer, json.dumps({"set": {"nonsense": 1}}).encode())
        seq, _ = viewer.wait_for_frame(TIMEOUT)
        viewer.wait_for_frame(TIMEOUT, after=seq)
        assert viewer.error is None

    def test_materials_and_previews(self, viewer):
        mats = json.loads(_get(viewer, "/materials").read())
        assert mats["names"] == ["standin_a", "standin_b"]
        assert mats["selected"] == 1
        strip = _decode(_get(viewer, "/preview/1.jpg?t=3").read())
        assert strip.shape == (128, 6 * 128, 3)
        for bad in ("/preview/7.jpg", "/preview/x.jpg"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(viewer, bad)
            assert err.value.code == 404

    def test_event_queue_cap(self, viewer):
        """A flood past the cap drops the oldest events, not the server."""
        before = viewer.events_dropped
        flood = [{"cursor": [i % 7, 0]}
                 for i in range(serve._EVENT_QUEUE_CAP + 50)]
        assert _post(viewer, json.dumps(flood).encode()).status == 200
        assert viewer.events_dropped >= before + 50
        seq, _ = viewer.wait_for_frame(TIMEOUT)
        viewer.wait_for_frame(TIMEOUT, after=seq)
        assert viewer.error is None

    def test_stream_yields_multipart_frames(self, viewer):
        r = _get(viewer, "/stream")
        assert r.headers["Content-Type"].startswith(
            "multipart/x-mixed-replace")
        buf = b""
        while buf.count(b"--bibimframe") < 2:
            buf += r.read1(65536)
        r.close()
        part = buf.split(b"--bibimframe")[1]
        jpeg = part.split(b"\r\n\r\n", 1)[1]
        assert jpeg[:2] == b"\xff\xd8"


def test_render_loop_failure_is_raised(standin, tmp_path):
    """A scene whose asset is missing ends the render loop on its first
    frame: wait_for_frame and stop() raise it (the loader's
    FileNotFoundError), /frame.jpg answers 500, and both threads end."""
    ui = UiState(scene="mesh", mesh_path=str(tmp_path / "missing.obj"))
    session = Session(width=128, height=64, ui=ui, readback_depth=1,
                      device="cpu")
    v = ViewerServer(session, port=0).start()
    with pytest.raises(FileNotFoundError):
        v.wait_for_frame(TIMEOUT)
    assert isinstance(v.error, FileNotFoundError)
    with pytest.raises(urllib.error.HTTPError) as http_err:
        _get(v, "/frame.jpg")
    assert http_err.value.code == 500
    with pytest.raises(FileNotFoundError):
        v.stop()
    assert not _viewer_threads()
