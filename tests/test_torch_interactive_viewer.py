"""The port's interactive HTTP viewer (``viewer/interactive.py``) on the CPU,
against the JAX package's viewer on the same PLY.

Tolerances: pages byte-equal to the JAX viewer's; a ``/frame`` PNG and the
golden key's frame within one 8-bit level of the JAX viewer's (frames
within 1e-4 of each other can round to neighbouring levels); camera poses
after a key sequence equal to the JAX ``apply_key``'s exactly;
``encode_png`` decodes to its input array exactly.
"""

import json
import struct
import sys
import threading
import urllib.request
import zlib

import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu import Splats as JaxSplats
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.viewer import interactive as jinteractive

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import viewer
from openglgaussiansplattingrenderer_tpu_torch.io import png as png_io
from openglgaussiansplattingrenderer_tpu_torch.viewer import interactive
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = dict(use_pallas=False, chunk=32, max_per_tile=128, dup_capacity_factor=24.0)
KEYS = ["w", "a", "right", "up", "space", "d", "left", "shift", "s", "down", "q"]


def decode_png(data: bytes) -> np.ndarray:
    """The 8-bit RGB/RGBA, filter-0 PNGs ``encode_png`` writes -> array."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == (
            zlib.crc32(tag + body) & 0xFFFFFFFF)
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert depth == 8 and ctype in (2, 6)
    c = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert not raw[:, 0].any(), "a row filter other than 0"
    return raw[:, 1:].reshape(h, w, c)


def pil_decode(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    s = jax_ply.make_synthetic_scene(30, seed=2, extent=1.5)
    p = str(tmp_path_factory.mktemp("viewer") / "scene.ply")
    jax_ply.save_ply(p, s["means"], s["quats"], s["scales"], s["opacities"], s["colors"])
    return p


@pytest.fixture(scope="module")
def jax_state(scene_path):
    return jinteractive.ViewerState(JaxSplats(scene_path, 64, 64, cfg=JaxConfig(**OPTS)),
                                    JaxCamera(0.0, 0.0, -4.0, width=64, height=64))


@pytest.fixture()
def server(scene_path):
    splats = port.Splats(scene_path, 64, 64, cfg=port.RenderConfig(**OPTS), device="cpu")
    cam = port.Camera(0.0, 0.0, -4.0, width=64, height=64)
    srv = interactive.make_server(splats, cam, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, cam
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def _get(srv, path):
    port_ = srv.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port_}{path}", timeout=120) as r:
        return r.read(), dict(r.headers)


def _jax_png(state, key):
    png, stats = state.render_png(key)
    return pil_decode(png), stats


def test_pages_match_jax(server):
    srv, _ = server
    assert _get(srv, "/")[0] == interactive.PAGE == jinteractive.PAGE
    assert _get(srv, "/live")[0] == interactive.LIVE_PAGE == jinteractive.LIVE_PAGE
    assert b"keydown" in interactive.PAGE and b"/stream" in interactive.LIVE_PAGE
    assert viewer.interactive is interactive


def test_frame_and_key_sequence_match_jax(server, jax_state):
    srv, cam = server
    png, headers = _get(srv, "/frame")
    stats = json.loads(headers["X-Stats"])
    assert stats["pos"] == [0.0, 0.0, -4.0] and "num_records" in stats
    assert stats["encoder"] == interactive.encoder_name("PNG")
    want, want_stats = _jax_png(jax_state, None)
    got = pil_decode(png)
    assert got.shape == want.shape == (64, 64, 3)
    assert got.max() > 20, "the frame shows nothing"
    assert np.abs(got.astype(int) - want).max() <= 1
    assert stats["num_records"] == want_stats["num_records"]

    # the reference's key loop: the same keys move both cameras alike
    jcam = jax_state.camera
    for k in KEYS:
        png, headers = _get(srv, f"/frame?key={k}")
        jinteractive.ViewerState.apply_key(jax_state, k)
        assert json.loads(headers["X-Stats"])["pos"] == [
            round(float(v), 3) for v in jcam.position]
    np.testing.assert_array_equal(cam.position, jcam.position)
    np.testing.assert_array_equal(cam.rotation, jcam.rotation)
    np.testing.assert_array_equal(cam.get_view_matrix(), jcam.get_view_matrix())
    np.testing.assert_array_equal(cam.get_vp_matrix(), jcam.get_vp_matrix())
    want, _ = _jax_png(jax_state, None)      # the frame at the moved pose
    assert np.abs(pil_decode(png).astype(int) - want).max() <= 1

    # apply_key on its own, as the module function
    c1, c2 = port.Camera(0.0, 0.0, -4.0), JaxCamera(0.0, 0.0, -4.0)
    for k in KEYS:
        interactive.apply_key(c1, k)
        jinteractive.ViewerState(None, c2).apply_key(k)
    np.testing.assert_array_equal(c1.get_view_matrix(), c2.get_view_matrix())


def test_golden_key_matches_jax(server, jax_state):
    srv, _ = server
    png, headers = _get(srv, "/frame?key=c")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert json.loads(headers["X-Stats"])["path"] == "golden"
    jax_state.camera = JaxCamera(0.0, 0.0, -4.0, width=64, height=64)
    want, want_stats = _jax_png(jax_state, "c")
    assert want_stats["path"] == "golden"
    got = pil_decode(png)
    assert got.max() > 20
    assert np.abs(got.astype(int) - want).max() <= 1


def test_live_stream_delivers_frames_and_fps(server):
    """/stream is a continuous multipart/x-mixed-replace loop: queued /key
    presses apply between frames and the server measures delivered fps."""
    srv, cam = server
    srv.stream_max_frames = 4
    _get(srv, "/key?key=w")        # queued before the stream starts
    body, headers = _get(srv, "/stream")
    assert "multipart/x-mixed-replace" in headers["Content-Type"]
    frames = [p for p in body.split(b"--gsframe\r\n") if p.strip()]
    assert len(frames) == 4
    _, ctype = interactive.stream_format()
    for p in frames:
        head, _, payload = p.partition(b"\r\n\r\n")
        assert ctype.encode() in head
        assert payload[:2] == b"\xff\xd8" or payload[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_allclose(cam.position, [0.0, 0.0, -3.9], atol=1e-6)
    stats = json.loads(_get(srv, "/stats")[0])
    assert stats["stream_frames"] == 4 and stats["stream_fps"] > 0
    assert "num_records" in stats and stats["pos"] == [0.0, 0.0, -3.9]
    assert stats["encoder"] == interactive.encoder_name(interactive.stream_format()[0])


def test_encode_png_without_pil(server, monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (4, 9, 4), dtype=np.uint8)
    for arr in (rgb, rgba):
        data = png_io.encode_png(arr)
        np.testing.assert_array_equal(decode_png(data), arr)
        np.testing.assert_array_equal(pil_decode(data), arr)
        assert png_io.encode_png(arr) == data
    with pytest.raises(ValueError):
        png_io.encode_png(rgb.astype(np.float32))

    srv, _ = server
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)       # hide PIL
        assert interactive.encoder_name("PNG") == "encode_png"
        assert interactive.stream_format() == ("PNG", "image/png")
        frame = rng.uniform(0, 1, (6, 8, 4)).astype(np.float32)
        data = interactive.encode_frame(frame, "PNG")
        np.testing.assert_array_equal(decode_png(data), png_io.to_uint8(frame[..., :3]))
        with pytest.raises(ValueError, match="PIL"):
            interactive.encode_frame(frame, "JPEG")
        # the server then streams PNG and says so
        srv.stream_max_frames = 2
        body, _ = _get(srv, "/stream")
        assert body.count(b"Content-Type: image/png") == 2
        assert json.loads(_get(srv, "/stats")[0])["encoder"] == "encode_png"
        png, headers = _get(srv, "/frame")
        assert json.loads(headers["X-Stats"])["encoder"] == "encode_png"
        assert decode_png(png).shape == (64, 64, 3)
        # and save_png writes the same bytes
        m.setattr(png_io, "_HAVE_PIL", False)
        png_io.save_png(str(tmp_path / "f.png"), frame)
        assert (tmp_path / "f.png").read_bytes() == png_io.encode_png(
            png_io.to_uint8(frame))


def test_main_refuses_cuda_without_a_card(scene_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would serve forever")
    assert interactive.main([scene_path, "--no-autotune"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
