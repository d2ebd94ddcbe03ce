"""The port's offline viewer (``viewer/offline.py``) and timing utilities
(``utils/timing.py``) on the CPU against the JAX package's.

Tolerances: orbit camera matrices, focals and tan-fovs equal; frame-timer
summaries of the same frame times equal; an orbit frame within 1e-4 of
the JAX package's oracle frame (the frame contract of the parity tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args
from openglgaussiansplattingrenderer_tpu.utils import timing as jtiming
from openglgaussiansplattingrenderer_tpu.viewer import offline as joffline

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert, viewer
from openglgaussiansplattingrenderer_tpu_torch.io.png import load_png
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args
from openglgaussiansplattingrenderer_tpu_torch.utils import timing
from openglgaussiansplattingrenderer_tpu_torch.viewer import offline
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = dict(use_pallas=False, chunk=32, max_per_tile=256, dup_capacity_factor=32.0)


@pytest.mark.parametrize("center,radius,frames,offset", [
    ((0.0, 0.0, 0.0), 5.0, 6, 0.5),
    ((0.3, -1.2, 2.5), 8.0, 7, -0.25),
])
def test_orbit_cameras_match_jax(center, radius, frames, offset):
    got = offline.orbit_cameras(center, radius, frames, height_offset=offset,
                                width=96, height=48, fovy=50.0)
    want = joffline.orbit_cameras(center, radius, frames, height_offset=offset,
                                  width=96, height=48, fovy=50.0)
    assert len(got) == len(want) == frames
    for c, jc in zip(got, want):
        assert isinstance(c, port.Camera)
        np.testing.assert_array_equal(c.get_view_matrix(), jc.get_view_matrix())
        np.testing.assert_array_equal(c.get_vp_matrix(), jc.get_vp_matrix())
        a, ja = camera_args(c), jax_camera_args(jc)
        for k in ja:
            np.testing.assert_array_equal(a[k], ja[k], err_msg=k)
    assert viewer.orbit_cameras is offline.orbit_cameras


def test_render_frame_and_orbit(tmp_path):
    scene = jax_ply.make_synthetic_scene(30, seed=4, extent=1.0)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    cfg = port.RenderConfig(**OPTS)
    cams = offline.orbit_cameras((0.0, 0.0, 0.0), 4.0, 3, width=64, height=64)
    params = convert.params_from_numpy(scene, "cpu")
    img = offline.render_frame(params, cams[1], cfg, path=str(tmp_path / "f.png"))
    want = joffline.render_frame({k: jnp.asarray(v) for k, v in scene.items()},
                                 joffline.orbit_cameras((0.0, 0.0, 0.0), 4.0, 3,
                                                        width=64, height=64)[1],
                                 JaxConfig(**OPTS))
    assert isinstance(img, np.ndarray) and img.shape == (64, 64, 4)
    np.testing.assert_allclose(img, want, atol=1e-4)
    assert img[..., :3].max() > 0.05, "the orbit camera sees nothing"
    assert load_png(str(tmp_path / "f.png")).shape == (64, 64, 3)
    summary = offline.render_orbit(params, str(tmp_path / "orbit"), radius=4.0,
                                   num_frames=3, cfg=cfg, width=32, height=32,
                                   verbose=False)
    assert sorted(p.name for p in (tmp_path / "orbit").iterdir()) == [
        f"frame_{i:04d}.png" for i in range(3)]
    assert summary["frames"] == 3 and summary["fps"] > 0
    assert set(summary) == {"frames", "mean_ms", "p50_ms", "p95_ms", "fps"}


def test_frame_timer_summary_matches_jax():
    for frames in ([], [12.0], [30.0, 10.0, 12.5, 11.0, 40.0]):
        t, jt = timing.FrameTimer(), jtiming.FrameTimer()
        t.frames_ms, jt.frames_ms = list(frames), list(frames)
        assert t.summary() == jt.summary()
    t = timing.FrameTimer()
    t.start()
    ms = t.stop({"img": torch.zeros(3), "stats": [torch.ones(2), 3]})
    assert ms >= 0 and t.frames_ms == [ms]


def test_fence_and_time_stages_on_the_cpu(monkeypatch):
    # CPU tensors are computed already: no CUDA call is made for them
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("synchronize on CPU tensors"))
    assert timing.fence({"a": torch.ones(2), "b": (torch.zeros(1), [1.0])}) is None
    assert timing.fence([]) is None
