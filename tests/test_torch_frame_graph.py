"""The frame graph's policy (``frame_graph.FrameGraphs``) and the frame's
device-side values (``utils/device.py``), on the CPU.

No card is needed: the capture is a fake that runs the frame once into
static outputs, and a replay runs it again and copies into them, as a
graph's replay rewrites its static outputs. The frames run the kernels'
plain versions, so the policy sees the same calls as on a card:

- the first frame of a key runs eagerly, the second captures, later ones
  replay, and a change of address, shape, stride, dtype, scalar,
  ``RenderConfig`` or device changes the key;
- an input that needs a gradient, and grad mode, keep the graph out;
- a failed capture falls back, is counted and is not tried again;
- frames returned by replays share no memory with one another or with the
  static outputs, and hold their values after later frames;
- the kernels' launch counters after warm-up, capture and replays;
- the device-side constants and matrices equal what ``torch.tensor`` and
  ``torch.as_tensor`` make, and a frame with a background is bit-equal to
  one whose values come from them.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import frame_graph
from openglgaussiansplattingrenderer_tpu_torch.io import ply
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args
from openglgaussiansplattingrenderer_tpu_torch.utils import device as device_
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 64, 48
CFG = port.RenderConfig.for_resolution(W, H, tile_px=16, chunk=32, dup_capacity_factor=24.0,
                                       background=(0.25, 0.5, 1.0))


class FakeReplay:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def begin(self):
        pass

    def replay(self):
        # a graph's replay runs no Python: the wrappers count nothing here
        counters = frame_graph.launch_counters()
        before = [c.launches for c in counters]
        for static, new in zip(self.out, self.fn()):
            static.copy_(new)
        for c, b in zip(counters, before):
            c.launches = b


class FakeGraphs:
    """A capture that runs the frame into static outputs; ``fail`` refuses."""

    def __init__(self, fail=False):
        self.fail, self.warm_ups, self.captured = fail, 0, 0

    def usable(self, device):
        return True

    def warm_up(self, fn, device):
        self.warm_ups += 1
        fn()

    def capture(self, fn, device):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.captured += 1
        out = fn()
        return FakeReplay(fn, out), out


def counter():
    return types.SimpleNamespace(captures=0, replays=0, eager=0, capture_failures=0)


def graphs(fail=False):
    return frame_graph.FrameGraphs(counter(), FakeGraphs(fail))


def counts(fg):
    c = fg.counter
    return c.eager, c.captures, c.replays, c.capture_failures


def scene(n=60):
    s = ply.make_synthetic_scene(n, seed=3, extent=2.0)
    return {k: torch.from_numpy(v) for k, v in s.items() if k != "sh_rest"}


def pose(i):
    """Pose i of a short orbit: its camera arguments (numpy matrices)."""
    return camera_args(port.Camera(0.3 * np.sin(i), 0.2 * np.cos(i), -6.0 - 0.1 * i,
                                   width=W, height=H))


def frame(fg, params, a, cfg=CFG, width=W, height=H, **over):
    a = dict(a, **over)
    return fg.render(params, a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
                     a["tan_fovy"], width, height, cfg)


def eager(params, a, cfg=CFG, width=W, height=H, **over):
    a = dict(a, **over)
    view, vp = (torch.as_tensor(a[k], dtype=torch.float32) for k in ("view", "vp"))
    return fastpath.render_fast(params, view, vp, a["focal_x"], a["focal_y"], a["tan_fovx"],
                                a["tan_fovy"], width, height, cfg)


def assert_same_frame(got, want):
    (img, st), (img0, st0) = got, want
    assert torch.equal(img, img0)
    assert list(st) == list(st0)
    for k in st0:
        assert st[k].dtype == st0[k].dtype and st[k].shape == st0[k].shape, k
        assert torch.equal(st[k], st0[k]), k


@pytest.mark.parametrize("matrices", ["numpy", "tensors_the_graph_does_not_copy_in"])
def test_a_key_captures_on_its_second_frame_and_replays_after(matrices):
    fg, params = graphs(), scene()
    expect = [(1, 0, 0, 0), (1, 1, 1, 0), (1, 1, 2, 0), (1, 1, 3, 0), (1, 1, 4, 0)]
    with torch.no_grad():
        for i, want in enumerate(expect):
            a = pose(i)
            if matrices != "numpy":     # not host matrices: copied in before the replay
                a = {**a, **{k: torch.as_tensor(a[k]).requires_grad_(True)
                             for k in ("view", "vp")}}
            got = frame(fg, params, a)
            assert counts(fg) == want, i
            assert_same_frame(got, eager(params, pose(i)))      # the pose reached the graph
    assert fg.backend.warm_ups == 1 and fg.backend.captured == 1
    assert (next(iter(fg._frames.values())).staging is None) == (matrices != "numpy")


def _changed(params, what):
    p = dict(params)
    if what == "pointer":
        p["means"] = params["means"].clone()
    elif what == "shape":           # the same addresses, one splat fewer
        p = {k: v[:-1] for k, v in params.items()}
    elif what == "stride":
        m = torch.empty((3, params["means"].shape[0]), dtype=torch.float32).t()
        p["means"] = m.copy_(params["means"])
    elif what == "dtype":
        p["opacities"] = params["opacities"].view(torch.int32)
    return p


@pytest.mark.parametrize("what", ["pointer", "shape", "stride", "dtype", "focal", "tangent",
                                  "width", "config", "device"])
def test_the_key_changes_with_each_input_the_capture_bakes_in(what):
    params, a, b = scene(), pose(0), pose(1)
    args = [a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H,
            CFG]
    key = frame_graph.frame_key(params, *args)
    assert key == frame_graph.frame_key(dict(params), *args)
    # the matrices are the graph's input, not part of its key
    assert key == frame_graph.frame_key(params, b["view"], b["vp"], *args[2:])
    other = list(args)
    if what in ("pointer", "shape", "stride", "dtype"):
        params = _changed(params, what)
    elif what == "focal":
        other[2] = np.float32(a["focal_x"] * 1.001)
    elif what == "tangent":
        other[5] = np.float32(a["tan_fovy"] * 1.001)
    elif what == "width":
        other[6] = W - 16
    elif what == "config":
        other[8] = dataclasses.replace(CFG, alpha_min=2.0 / 255.0)
    else:
        params = {k: v.to("meta") for k, v in params.items()}
    assert frame_graph.frame_key(params, *other) not in (None, key)


@pytest.mark.parametrize("what", ["pointer", "shape", "stride", "focal", "config"])
def test_a_changed_input_runs_eager_then_captures_again(what):
    fg, params = graphs(), scene()
    cfg, over = CFG, {}
    frame(fg, params, pose(0))
    frame(fg, params, pose(1))
    assert counts(fg) == (1, 1, 1, 0)
    if what == "focal":
        over = {"focal_x": np.float32(pose(0)["focal_x"] * 1.01)}
    elif what == "config":
        cfg = dataclasses.replace(CFG, background=(0.0, 0.0, 0.0))
    else:
        params = _changed(params, what)
    for i, want in enumerate([(2, 1, 1, 0), (2, 2, 2, 0), (2, 2, 3, 0)]):
        got = frame(fg, params, pose(2 + i), cfg, **over)
        assert counts(fg) == want, i
        assert_same_frame(got, eager(params, pose(2 + i), cfg, **over))


def test_keys_that_alternate_never_capture_and_a_return_recaptures():
    fg, a, b = graphs(), scene(), scene(50)
    for p in (a, b, a, b):
        frame(fg, p, pose(0))
    assert counts(fg) == (4, 0, 0, 0)
    frame(fg, b, pose(0))
    frame(fg, a, pose(0))               # the graph is b's: a runs eagerly
    frame(fg, a, pose(0))               # a twice in a row: b's graph goes
    assert counts(fg) == (5, 2, 2, 0)
    assert [f.key for f in fg._frames.values()] == [frame_graph.frame_key(
        a, pose(0)["view"], pose(0)["vp"], pose(0)["focal_x"], pose(0)["focal_y"],
        pose(0)["tan_fovx"], pose(0)["tan_fovy"], W, H, CFG)]


@pytest.mark.parametrize("how,captures", [("requires_grad", 0), ("view_requires_grad", 0),
                                          ("no_grad", 1), ("grad_mode_off_only", 1)])
def test_inputs_that_need_a_gradient_bypass_the_graph(how, captures):
    fg, params, over = graphs(), scene(), {}
    if how in ("requires_grad", "no_grad"):
        params = {k: v.requires_grad_(True) for k, v in params.items()}
    if how == "view_requires_grad":
        over = {"view": torch.as_tensor(pose(0)["view"]).requires_grad_(True)}
    grad = torch.enable_grad() if how in ("requires_grad", "view_requires_grad") \
        else torch.no_grad()
    with grad:
        for i in range(3):
            img, _ = frame(fg, params, pose(0), **over)
    assert counts(fg) == ((3, 0, 0, 0) if captures == 0 else (1, 1, 2, 0))
    assert img.requires_grad == (captures == 0)


def test_a_failed_capture_falls_back_is_counted_and_not_tried_again():
    fg, params = graphs(fail=True), scene()
    got = [frame(fg, params, pose(0))]
    with pytest.warns(RuntimeWarning, match="capture failed"):
        got.append(frame(fg, params, pose(1)))
    for i in range(2, 4):
        got.append(frame(fg, params, pose(i)))
    assert counts(fg) == (4, 0, 0, 1)
    assert "not permitted when stream is capturing" in fg.last_error
    assert fg.backend.warm_ups == 1
    for i, g in enumerate(got):
        assert_same_frame(g, eager(params, pose(i)))


def test_frames_from_replays_share_no_memory_and_keep_their_values():
    fg, params = graphs(), scene()
    frames = [frame(fg, params, pose(i)) for i in range(4)]
    assert counts(fg) == (1, 1, 3, 0)
    static = next(iter(fg._frames.values()))
    ptrs = set()
    for img, st in frames[1:]:
        for t in (img, *st.values()):
            ptrs.add(t.untyped_storage().data_ptr())
    assert len(ptrs) == 2 * 3                  # one image and one stats buffer a frame
    assert not ptrs & {static.image.untyped_storage().data_ptr(),
                       static.packed.untyped_storage().data_ptr()}
    for i, got in enumerate(frames):           # frame k after frames k+1 ...
        assert_same_frame(got, eager(params, pose(i)))


def test_launch_counters_count_the_warm_up_and_every_replay(monkeypatch):
    def fake_render_fast(params, view, vp, *frame_args):
        ks.cumsum.launches += 1
        kc.composite.launches += 2
        img = (params["means"][:, :1] * view[0, 0]).expand(-1, 4).contiguous()
        return img, {"num_records": params["means"].shape[0] + vp[3, 3].to(torch.int32)}

    monkeypatch.setattr(fastpath, "render_fast", fake_render_fast)
    monkeypatch.setattr(ks.cumsum, "launches", 0)
    monkeypatch.setattr(kc.composite, "launches", 0)
    fg, params = graphs(), scene()
    seen = []
    for i in range(4):
        frame(fg, params, pose(i))
        seen.append((ks.cumsum.launches, kc.composite.launches))
    # eager; warm-up then replay (the capture launches nothing); replays
    assert seen == [(1, 2), (3, 6), (4, 8), (5, 10)]
    assert counts(fg) == (1, 1, 3, 0)


def test_a_frame_queued_while_another_holds_the_graph_runs_eagerly():
    fg, params = graphs(), scene()
    frame(fg, params, pose(0))
    frame(fg, params, pose(1))
    out = []
    with fg._lock:                             # a replay being queued
        t = threading.Thread(target=lambda: out.append(frame(fg, params, pose(2))))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and len(out) == 1
    assert counts(fg) == (2, 1, 1, 0)
    assert_same_frame(out[0], eager(params, pose(2)))


def test_clear_drops_the_graph():
    fg, params = graphs(), scene()
    for i in range(2):
        frame(fg, params, pose(i))
    fg.clear()
    frame(fg, params, pose(2))
    assert counts(fg) == (2, 1, 1, 0) and not fg._frames


@pytest.mark.parametrize("kind", ["the_frame's", "mixed"])
def test_pack_and_unpack_keep_every_stat_bit_for_bit(kind):
    if kind == "mixed":
        stats = {"a": torch.tensor(7, dtype=torch.int32), "b": torch.tensor(2.5),
                 "c": torch.tensor(-3, dtype=torch.int64), "d": torch.tensor(True),
                 "e": torch.arange(6, dtype=torch.int16).reshape(2, 3),
                 "f": torch.tensor(float("nan")), "g": torch.tensor(11, dtype=torch.int32),
                 "h": torch.tensor([1.5, -2.0], dtype=torch.float64)}
        size = 4 + 4 + 8 + 1 + 12 + 4 + 4 + 16
    else:
        stats = eager(scene(), pose(0))[1]
        size = 4 * len(stats)
    packed, layout = frame_graph.pack(stats)
    assert packed.dtype == torch.uint8 and packed.numel() == size
    back = frame_graph.unpack(packed.clone(), layout)
    assert list(back) == list(stats)

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    for k, v in stats.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(bits(back[k]), bits(v)), k


@pytest.mark.parametrize("kind", ["background", "arange", "numpy_f32", "numpy_f64",
                                  "cpu_tensor_f64", "list"])
def test_device_side_values_equal_what_torch_makes(kind):
    cpu = torch.device("cpu")
    if kind == "background":
        got = device_.constant((0.25, 1.0 / 3.0, 1.0), torch.float32, cpu)
        assert got is device_.constant([0.25, 1.0 / 3.0, 1.0], torch.float32, cpu)
        assert torch.equal(got, torch.tensor((0.25, 1.0 / 3.0, 1.0), dtype=torch.float32))
        return
    if kind == "arange":
        got = device_.arange(12, torch.int32, cpu)
        assert got is device_.arange(12, torch.int32, cpu)
        assert torch.equal(got, torch.arange(12, dtype=torch.int32))
        return
    rng = np.random.default_rng(5)
    view, vp = rng.standard_normal((4, 4)) / 3.0, rng.standard_normal((4, 4)) * 1e3
    if kind == "numpy_f32":
        view, vp = view.astype(np.float32), vp.astype(np.float32)
    elif kind == "cpu_tensor_f64":
        view, vp = torch.from_numpy(view), torch.from_numpy(vp)
    elif kind == "list":
        view, vp = view.tolist(), vp.tolist()
    want = [torch.as_tensor(m, dtype=torch.float32) for m in (view, vp)]
    buf = torch.empty((2, 4, 4), dtype=torch.float32)
    device_.fill_host(buf.numpy(), view, vp)         # what the pinned ring stages
    got = device_.matrices(view, vp, cpu)
    out = torch.zeros((2, 4, 4))
    into = device_.matrices(view, vp, cpu, out=out)
    for i in range(2):
        for t in (buf[i], got[i], into[i]):
            assert t.dtype == torch.float32 and torch.equal(t, want[i])
        assert into[i].data_ptr() == out[i].data_ptr()


def _before_part_one(monkeypatch):
    """The values as the frame made them before they came from
    ``utils/device.py``: fresh ``torch.tensor`` / ``torch.as_tensor``."""
    monkeypatch.setattr(device_, "constant", lambda v, dtype, device: torch.tensor(
        v, dtype=dtype, device=device))
    monkeypatch.setattr(device_, "arange", lambda n, dtype, device: torch.arange(
        n, dtype=dtype, device=device))
    monkeypatch.setattr(device_, "matrices", lambda view, vp, device: tuple(
        torch.as_tensor(m, dtype=torch.float32, device=device) for m in (view, vp)))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_a_frame_with_a_background_is_bit_equal_to_the_values_made_in_place(
        monkeypatch, use_pallas):
    cfg = dataclasses.replace(CFG, use_pallas=use_pallas)
    params, a = scene(), pose(3)
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H,
            cfg)
    now = port.render_arrays(params, *args)
    assert float(now[0][..., :3].amax()) > 0.0 and float(now[0][..., 3].amin()) < 1.0
    with monkeypatch.context() as m:
        _before_part_one(m)
        before = port.render_arrays(params, *args)
    assert_same_frame(now, before)
