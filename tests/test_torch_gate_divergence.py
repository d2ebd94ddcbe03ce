"""The float64 replay of ``scripts/torch_gate_divergence.py`` on the CPU.

The script itself needs a card; its replay does not. Held here: the replay
of a pixel equals the oracle's frame at that pixel; a record on the 1/255
cutoff and one whose blend lands on the 0.99 break are named with the
change their flip predicts; two record streams that differ in one branch
name that record and branch, and a flip inside one frame's own rounding
is named where the two streams agree.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_gate_divergence.py"
_SPEC = importlib.util.spec_from_file_location("torch_gate_divergence", _PATH)
gd = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(gd)

CFG = RenderConfig(grid_x=1, grid_y=1)


class _Stream:
    """One tile's records, as ``gd.Stream`` hands them out."""

    def __init__(self, rec):
        self.rec = np.asarray(rec, np.float64)

    def tile_of(self, px, py):
        return 0

    def records(self, t):
        return 0, self.rec


def _centred(opacities, colors):
    """Records centred on pixel (0, 0) with a unit conic: alpha = opacity."""
    n = len(opacities)
    rec = np.zeros((9, n))
    rec[2] = rec[4] = 1.0
    rec[5] = opacities
    rec[6:9] = np.asarray(colors, np.float64).T
    return rec


def test_replay_equals_the_oracle_frame():
    scene = {k: v for k, v in ply_io.make_synthetic_scene(
        300, seed=7, extent=2.0).items() if k != "sh_rest"}
    cfg = RenderConfig(use_pallas=True, chunk=64, dup_capacity_factor=24.0)
    a = camera_args(Camera(0.0, 0.0, -6.0, width=64, height=64))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], 64, 64)
    params = params_from_numpy(scene, "cpu")
    stream = gd.Stream(params, args, cfg)
    img, _ = render_arrays(params, *args, cfg)
    img = img.numpy()
    rng = np.random.default_rng(0)
    for px, py in [(32, 32), (31, 33), *rng.integers(0, 64, (6, 2)).tolist()]:
        _, rec = stream.records(stream.tile_of(px, py))
        pixel = gd.blend(rec, px, py, cfg)[0]
        np.testing.assert_allclose(pixel, img[py, px], atol=2e-5)
    assert img[..., 3].max() > 0.5


def test_borderline_alpha_min():
    a_min = CFG.alpha_min
    rec = _centred([0.5, a_min + 1e-7, 0.3], [[10, 10, 10], [255, 0, 0], [0, 20, 0]])
    found = gd.attribute(_Stream(rec), [(0, 0, 0.5 * a_min)], CFG)
    (f,) = found
    (c,) = f["culprits"]
    assert c["record"] == 1 and c["branch"] == "alpha_min"
    assert 0 < c["margin"] < gd.FLIP_EPS
    # dropping it takes its alpha * T * colour (and its share of what follows)
    assert abs(c["predicted_diff"] - a_min * 0.5) < 1e-4
    assert c["matches"] and f["explained"]


def test_borderline_saturation():
    # after 0.9 and 0.9 the transmittance is 0.01 to within float64's
    # rounding: the third record is blended or not, on an ulp
    rec = _centred([0.9, 0.9, 0.5], [[0, 0, 0], [0, 0, 0], [0, 255, 0]])
    (c,) = gd.borderline(rec, 0.0, 0.0, CFG)
    assert c["record"] == 1 and c["branch"] == "saturation"
    assert abs(c["margin"]) < 1e-12
    assert abs(c["predicted_diff"] - 0.5 * 0.01) < 1e-6
    # and a record far from both thresholds names nothing
    assert gd.borderline(_centred([0.5], [[1, 1, 1]]), 0.0, 0.0, CFG) == []


@pytest.mark.parametrize("branch", ["alpha_min", "saturation", "values"])
def test_two_streams_name_the_flip(branch):
    a_min = CFG.alpha_min
    f32 = _centred([0.5, 0.8, 0.3, 0.6], [[40, 40, 40]] * 4)
    q16 = f32.copy()
    if branch == "alpha_min":
        f32[5, 2] = a_min * 1.001
        q16[5, 2] = a_min * 0.999
    elif branch == "saturation":
        # 0.5, 0.8: T 0.1; the third record's alpha takes T over or under 0.01
        f32[5, 2] = 0.9 + 1e-4
        q16[5, 2] = 0.9 - 1e-4
    else:
        q16[6, 1] = 41.0
    observed = np.abs(gd.blend(q16, 0.0, 0.0, CFG)[0] - gd.blend(f32, 0.0, 0.0, CFG)[0]).max()
    (f,) = gd.attribute_two_streams(_Stream(f32), _Stream(q16), [(0, 0, observed)], CFG)
    assert f["branch"] == branch and f["explained"]
    assert f["record"] == (1 if branch == "values" else 2)


def test_two_streams_name_a_rounding_flip():
    # the streams agree, but the third record sits on the saturation break:
    # a frame that rounded it to the other side differs by its contribution
    rec = _centred([0.9, 0.9, 0.5], [[0, 0, 0], [0, 0, 0], [0, 255, 0]])
    (f,) = gd.attribute_two_streams(_Stream(rec), _Stream(rec.copy()),
                                    [(0, 0, 0.5 * 0.01)], CFG)
    assert f["branch"] == "values" and f["replayed_diff"] == 0.0
    assert f["f32_borderline"][0]["branch"] == "saturation"
    assert f["f32_borderline"][0]["matches"] and f["explained"]
