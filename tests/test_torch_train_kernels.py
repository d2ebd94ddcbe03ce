"""The train step's two kernels' plain versions against the JAX package.

``ops/kernels/adam.py`` (Adam over every raw tensor in one launch) and
``ops/kernels/ssim_loss.py`` (the L1 + D-SSIM loss and its backward) run
their kernels only on the card. Here, on the CPU, their plain versions are
held to the JAX package on inputs drawn from numpy seeds: the written-out
Adam to optax's ``adam`` through JAX's ``make_optimizer``, and the
separable restatement of the loss kernels' arithmetic (``ssim_terms``,
``gs_loss_separable_plain`` and its analytic backward) to ``gs_loss`` and
``jax.grad`` of its conv form. The argument structs the kernels read and
the loss's input checks are held here too; the kernels themselves are held
to these plain versions in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.train import losses as jax_losses
from openglgaussiansplattingrenderer_tpu.train import trainer as jax_trainer

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl
from openglgaussiansplattingrenderer_tpu_torch.train import losses, trainer
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 37
SHAPES = {"means": (N, 3), "log_scales": (N, 3), "quats": (N, 4),
          "logit_opacities": (N,), "colors": (N, 3), "sh_rest": (N, 15, 3)}
SCHEDULE = dict(lr_means=1e-2, lr_means_final=1e-4, lr_means_decay_steps=8,
                lr_colors=0.25)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _adam_inputs(seed, steps):
    rng = np.random.default_rng(seed)
    raw = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(0, 1, s) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return raw, grads


@pytest.mark.parametrize("steps,tol", [(1, 1e-6), (10, 1e-5)])
def test_adam_update_plain_matches_optax(steps, tol):
    raw, grads = _adam_inputs(steps, steps)
    keys = tuple(SHAPES)
    opt = trainer.make_optimizer(trainer.TrainConfig(**SCHEDULE), keys)
    jopt = jax_trainer.make_optimizer(jax_trainer.TrainConfig(**SCHEDULE), keys)
    state = opt.init({k: torch.from_numpy(v) for k, v in raw.items()})
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    jstate = jopt.init(jraw)
    p = {k: torch.from_numpy(v) for k, v in raw.items()}
    for g in grads:
        lrs = {k: opt.learning_rate(k, state["count"]) for k in keys}
        updates, state = kadam.adam_update_plain(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, lrs)
        p = {k: p[k] + updates[k] for k in keys}
        jup, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jraw)
        jraw = optax.apply_updates(jraw, jup)
    assert state["count"] == steps
    for k in keys:
        # the stepped tensors, relative to their largest value (the position
        # rate decays on the schedule, sh_rest runs at lr_colors / 20)
        assert _rel(p[k], jraw[k]) <= tol, k
        if steps == 1:
            # the step itself, relative to its largest
            assert _rel(updates[k], jup[k]) <= tol, k


def test_optimizer_update_adds_the_step_to_raw():
    raw, (g,) = _adam_inputs(3, 1)
    opt = trainer.make_optimizer(trainer.TrainConfig(**SCHEDULE), tuple(SHAPES))
    raw_t = {k: torch.from_numpy(v) for k, v in raw.items()}
    g_t = {k: torch.from_numpy(v) for k, v in g.items()}
    state = opt.init(raw_t)
    updates, st1 = kadam.adam_update_plain(
        g_t, state, {k: opt.learning_rate(k, 0) for k in SHAPES})
    new_raw, st2 = opt.update(g_t, state, raw_t)
    for k in SHAPES:
        assert torch.equal(new_raw[k], raw_t[k] + updates[k]), k
        assert torch.equal(st1["mu"][k], st2["mu"][k]) and torch.equal(st1["nu"][k], st2["nu"][k])
        assert not state["mu"][k].any(), "the old state was written"
    assert st1["count"] == st2["count"] == 1


def test_adam_args_pack_as_the_kernel_reads_them():
    ptr = ctypes.sizeof(ctypes.c_void_p)
    m = kadam.MAX_KEYS
    # inputs, out, neg_lr, inv_c1 + inv_c2, n, out_at, role_stride,
    # first_chunk, first_elem, vec, five constants, keys + blocks, padding
    assert ctypes.sizeof(kadam.AdamArgs) == (4 * m * ptr + ptr + 4 * m + 8 + 8 * m + 8 * m + 8
                                             + 2 * 8 * (m + 1) + 4 * m + 20 + 8 + 4)
    raw, (g,) = _adam_inputs(4, 1)
    t = {k: torch.from_numpy(v) for k, v in raw.items()}
    keys = tuple(SHAPES)
    p = {k: v.clone() for k, v in t.items()}
    ins = [x for k in keys for x in (p[k], t[k], t[k], t[k])]
    ptrs = [x.data_ptr() for x in ins]
    lrs = {k: 1e-3 * (i + 1) / 3.0 for i, k in enumerate(keys)}
    a = kadam.plan_args([t[k].numel() for k in keys], [True] * len(keys))
    out = torch.empty(3 * a.role_stride)
    assert kadam.step_args(a, ptrs, out.data_ptr(), lrs, count=6) is a
    c1, c2 = kadam.bias_corrections(6)
    assert a.keys == len(keys)
    f32 = np.float32
    assert a.inv_c1 == f32(1.0 / c1) and a.inv_c2 == f32(1.0 / c2)
    assert a.one_minus_b1 == f32(1.0 - kadam.ADAM_B1) and a.b2 == f32(kadam.ADAM_B2)
    assert a.eps == f32(kadam.ADAM_EPS)
    assert a.out == out.data_ptr()
    for i, k in enumerate(keys):
        assert a.n[i] == t[k].numel()
        assert a.neg_lr[i] == f32(-lrs[k])
        assert a.inputs[4 * i + 1] == t[k].data_ptr()
        assert a.inputs[4 * i] == p[k].data_ptr() != a.inputs[4 * i + 1]
        # each key's outputs 16-byte aligned, one role after another
        assert a.out_at[i] % 4 == 0 and a.out_at[i] + a.n[i] <= a.role_stride
    # the bias corrections in float32: 1 - 0.999^7
    assert c2 == float(f32(1.0) - f32(0.999) ** f32(7))
    with pytest.raises(ValueError, match="keys"):
        kadam.plan_args([4] * (m + 1), [True] * (m + 1))


# key lengths and whether each key's inputs start on the 16-byte grid: one
# element, three, a chunk and one, a key off the grid among aligned ones,
# keys that end inside a chunk, an empty key, the most keys
PLAN_CASES = [((1,), (True,)), ((3, 4097), (True, True)),
              ((4097, 5_000, 1), (True, False, True)),
              ((4096, 4097, 4100, 12_287), (True,) * 4), ((0, 7), (True, False)),
              ((10_001,) * 8, (True, False) * 4), ((300_000, 3), (True, True))]


@pytest.mark.parametrize("lengths,aligned", PLAN_CASES)
def test_adam_plan_covers_every_element_once(lengths, aligned):
    a = kadam.plan_args(lengths, aligned)
    work = kadam.plan_work(a)
    seen = [np.zeros(n, np.int64) for n in lengths]
    for k, lo, hi, path in work:
        assert 0 <= lo < hi <= lengths[k], (k, lo, hi)
        seen[k][lo:hi] += 1
        if path == "chunk":
            # a chunk of one key, whole float4s, at most CHUNK elements
            assert aligned[k] and lo % kadam.CHUNK == 0 and (hi - lo) % 4 == 0
            assert hi - lo <= kadam.CHUNK
        else:
            # the element path: a key off the grid whole, else its last n % 4
            assert (lo, hi) == ((lengths[k] & ~3, lengths[k]) if aligned[k] else (0, lengths[k]))
    for k, s in enumerate(seen):
        assert (s == 1).all(), k
    chunks = sum(1 for w in work if w[3] == "chunk")
    elements = sum(w[2] - w[1] for w in work if w[3] == "element")
    assert (a.first_chunk[kadam.MAX_KEYS], a.first_elem[kadam.MAX_KEYS]) == (chunks, elements)
    assert a.blocks == chunks + -(-elements // kadam.THREADS)
    assert a.role_stride == sum(-(-n // 4) * 4 for n in lengths)


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors planned as if they lay on a card, with a fresh plan
    cache."""
    monkeypatch.setattr(kadam, "_PLANS", {})
    monkeypatch.setattr(kadam, "_DEVICE", lambda t: 0)


def _adam_tensors(n, seed, sh=True, off=()):
    """raw, grads and a state of ``n`` splats from numpy; the keys of
    ``off`` have their raw tensor one float past an allocation's start."""
    rng = np.random.default_rng(seed)
    shapes = {k: (n,) + s[1:] for k, s in SHAPES.items() if sh or k != "sh_rest"}

    def t(s, scale, shift=0):
        x = torch.from_numpy((rng.normal(0, 1, int(np.prod(s)) + shift) * scale)
                             .astype(np.float32))
        return x[shift:].view(s)

    raw = {k: t(s, 1.0, int(k in off)) for k, s in shapes.items()}
    grads = {k: t(s, 1e-3) for k, s in shapes.items()}
    state = {"count": 2, "mu": {k: t(s, 1e-3) for k, s in shapes.items()},
             "nu": {k: t(s, 1e-4).abs() for k, s in shapes.items()}}
    return raw, grads, state, {k: 1e-3 * (i + 1) for i, k in enumerate(shapes)}


def test_adam_plan_is_cached_on_shapes(fake_card):
    raw, grads, state, lrs = _adam_tensors(37, 1)
    plan, ins, ptrs = kadam.plan(grads, state, lrs, raw)
    assert isinstance(plan, kadam.Plan) and ptrs == [x.data_ptr() for x in ins]
    assert [plan.args.vec[i] for i in range(len(lrs))] == [1] * len(lrs)
    # fresh tensors of the same shapes: the same plan
    raw2, grads2, state2, _ = _adam_tensors(37, 2)
    assert kadam.plan(grads2, state2, lrs, raw2)[0] is plan
    # another capacity, another key set, a key off the grid: another plan each
    other = [kadam.plan(g, s, l, r)[0] for r, g, s, l in (
        _adam_tensors(38, 3), _adam_tensors(37, 4, sh=False), _adam_tensors(37, 5, off=("quats",)))]
    assert len({id(plan), *map(id, other)}) == 4
    assert [other[2].args.vec[i] for i in range(len(lrs))] == [1, 1, 0, 1, 1, 1]
    # the plan of the misaligned view covers each key once, quats element by element
    work = kadam.plan_work(other[2].args)
    assert {w[0] for w in work if w[3] == "element" and w[1] == 0} == {2}
    for k in range(len(lrs)):
        runs = sorted((lo, hi) for key, lo, hi, _ in work if key == k)
        assert runs[0][0] == 0 and runs[-1][1] == other[2].args.n[k]
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert other[0].args.n[0] == 38 * 3 and other[1].args.keys == len(lrs) - 1
    assert kadam.plan(grads, state, lrs, raw)[0] is plan
    # CPU tensors: the plain version's sentinel; views off the dense layout: none
    with pytest.MonkeyPatch.context() as m:
        m.setattr(kadam, "_DEVICE", torch.Tensor.get_device)
        assert kadam.plan(grads, state, lrs, raw)[0] is kadam._CPU
    strided = dict(raw, means=raw["means"].t().contiguous().t())
    assert kadam.plan(grads, state, lrs, strided)[0] is None


class _EmulatedKernel:
    """``gs_adam_step`` as ``csrc/adam.cu`` reads its struct, in numpy on
    host memory: every piece of ``plan_work`` read and written through the
    struct's pointers and offsets, a chunk only from 16-byte aligned
    inputs."""
    launches = 0

    def gs_adam_step(self, addr, stream):
        a = kadam.AdamArgs.from_address(addr)
        f32 = np.float32

        def array(p, n):
            return np.ctypeslib.as_array((ctypes.c_float * max(n, 1)).from_address(p))[:n]

        for k, lo, hi, path in kadam.plan_work(a):
            n = a.n[k]
            p, g, m, v = (array(a.inputs[4 * k + r], n)[lo:hi] for r in range(4))
            if path == "chunk":
                assert all(a.inputs[4 * k + r] % 16 == 0 for r in range(4))
            po, mo, vo = (array(a.out + 4 * (a.out_at[k] + r * a.role_stride), n)[lo:hi]
                          for r in range(3))
            mo[:] = f32(a.b1) * m + f32(a.one_minus_b1) * g
            vo[:] = f32(a.b2) * v + f32(a.one_minus_b2) * (g * g)
            po[:] = p + f32(a.neg_lr[k]) * ((mo * f32(a.inv_c1))
                                            / (np.sqrt(vo * f32(a.inv_c2)) + f32(a.eps)))
        self.launches += 1
        return 0


@pytest.mark.parametrize("n,off", [(1, ()), (5, ()), (1_367, ()), (1_367, ("quats",)),
                                   (701, tuple(SHAPES))])
def test_adam_update_fills_every_output_as_the_kernel_reads_them(fake_card, monkeypatch, n, off):
    """The CUDA branch of ``adam_update`` on host memory, the kernel
    emulated: the pointers, rates, output offsets and views that reach the
    C entry point give the plain step (to float32 rounding: numpy and
    torch's CPU kernels round the division otherwise), in new tensors of
    the inputs' shapes, the inputs unwritten."""
    kernel = _EmulatedKernel()
    monkeypatch.setattr(kadam, "_library", lambda: kernel)
    monkeypatch.setattr(kadam.build, "stream_ptr", lambda: 0)
    raw, grads, state, lrs = _adam_tensors(n, n, off=off)
    kept = {k: v.clone() for k, v in raw.items()}
    with torch.no_grad():
        new, st = kadam.adam_update(grads, state, lrs, raw)
    upd, want = kadam.adam_update_plain(grads, state, lrs)
    assert kernel.launches == 1 and st["count"] == 3
    for k in lrs:
        assert new[k].shape == raw[k].shape and new[k].is_contiguous()
        np.testing.assert_allclose(new[k].numpy(), (raw[k] + upd[k]).numpy(),
                                   rtol=1e-6, atol=1e-7)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(st[m][k].numpy(), want[m][k].numpy(), rtol=1e-6)
        assert torch.equal(raw[k], kept[k])
    # one allocation, 16-byte aligned parts, every output its own leaf
    assert len({v.untyped_storage().data_ptr() for d in (new, st["mu"], st["nu"])
                for v in d.values()}) == 1
    assert all(v.data_ptr() % 16 == 0 for v in new.values())
    leaf = new["means"].requires_grad_(True)
    (leaf * leaf).sum().backward()
    assert torch.equal(leaf.grad, 2 * new["means"].detach())
    with pytest.raises(NotImplementedError, match="no backward"):
        kadam.adam_update(grads, state, lrs, new)


def _images(seed, shape, flat=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    if flat:                                        # flat regions: E[p^2] - mu^2 cancels
        a[..., : shape[-3] // 2, :, :] = 0.25
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


# the kernels walk 32-column strips down in bands of 8 rows: (37, 70) leaves
# a partial strip and a partial band, B = 2 at (45, 75) too; the flat cases
# put the backward's partials (stored as float32) through the cancelling
# region
LOSS_SHAPES = [((40, 52, 3), False), ((11, 11, 3), False), ((11, 64, 3), False),
               ((64, 11, 3), False), ((2, 24, 24, 3), False), ((40, 52, 3), True),
               ((37, 70, 3), False), ((2, 45, 75, 3), False), ((2, 45, 75, 3), True)]


@pytest.mark.parametrize("shape,flat", LOSS_SHAPES)
def test_separable_loss_matches_jax(shape, flat):
    a, b = _images(len(shape) + shape[-2], shape, flat)
    want = jax_losses.gs_loss(jnp.asarray(a), jnp.asarray(b), 0.2)
    got = kl.gs_loss_separable_plain(torch.from_numpy(a), torch.from_numpy(b), 0.2)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    # the map itself, at ssim_map's tolerance against JAX
    s, _ = kl.ssim_terms(torch.from_numpy(a), torch.from_numpy(b))
    want_map = np.asarray(jax_losses.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    assert s.shape == want_map.shape
    assert float(np.abs(s.numpy() - want_map).max()) <= 1e-5 * max(1.0, np.abs(want_map).max())


@pytest.mark.parametrize("shape,flat", LOSS_SHAPES)
def test_separable_loss_backward_matches_jax_grad(shape, flat):
    a, b = _images(len(shape) + shape[-3], shape, flat)
    want = jax.grad(lambda x: jax_losses.gs_loss(x, jnp.asarray(b), 0.2))(jnp.asarray(a))
    got = kl.gs_loss_separable_bwd_plain(torch.from_numpy(a), torch.from_numpy(b),
                                         torch.tensor(1.0), 0.2)
    assert got.shape == a.shape
    assert _rel(got, want) <= 1e-5
    # a cotangent other than one scales it
    half = kl.gs_loss_separable_bwd_plain(torch.from_numpy(a), torch.from_numpy(b),
                                          torch.tensor(0.5), 0.2)
    assert _rel(half, 0.5 * np.asarray(want)) <= 1e-5


def test_gs_loss_routes_to_the_conv_form_on_the_cpu():
    a, b = _images(9, (24, 30, 3))
    x, y = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(losses.gs_loss(x, y, 0.2), losses.gs_loss_plain(x, y, 0.2))
    # the rendered image's first three channels, a strided view
    img = torch.from_numpy(np.concatenate([a, np.ones_like(a[..., :1])], -1))
    assert torch.equal(losses.gs_loss(img[..., :3], y, 0.2), losses.gs_loss_plain(x, y, 0.2))


@pytest.mark.parametrize("case", ["float64", "short", "narrow", "shapes", "devices", "rank"])
def test_gs_loss_checks_its_inputs(case):
    x = torch.rand((16, 16, 3))
    y = torch.rand((16, 16, 3))
    bad = {"float64": (x.double(), y.double(), TypeError),
           "short": (x[:10], y[:10], ValueError),
           "narrow": (x[:, :10], y[:, :10], ValueError),
           "shapes": (x, y[:15], ValueError),
           "devices": (x, torch.empty((16, 16, 3), device="meta"), ValueError),
           "rank": (x[0], y[0], ValueError)}
    p, t, err = bad[case]
    with pytest.raises(err):
        losses.gs_loss(p, t, 0.2)


def test_loss_args_pack_as_the_kernel_reads_them():
    assert ctypes.sizeof(kl.LossArgs) == 8 * 11 + 8 * 5 + 4 * 4 + 8 * 4 * 2 + 4 * 8
    img = torch.zeros((2, 20, 30, 4))
    pred, target = img[..., :3], torch.zeros((2, 20, 30, 3))
    a = kl.loss_args(pred, target, 0.2)
    assert (a.b, a.h, a.w, a.c) == (2, 20, 30, 3)
    assert tuple(a.ps) == (20 * 30 * 4, 30 * 4, 4, 1)
    assert tuple(a.ts) == (20 * 30 * 3, 30 * 3, 3, 1)
    # pred's pixels come 16 bytes whole; target's rows (30 x 3 floats, not
    # a multiple of 4) 4 bytes an element; the plan's fields wait for
    # gs_loss_plan on the card
    assert (a.pvec, a.tvec) == (kl.PIXELS, 0)
    wide = kl.loss_args(torch.zeros((20, 32, 4))[..., :3], torch.zeros((20, 32, 3)), 0.2)
    assert (wide.pvec, wide.tvec) == (kl.PIXELS, kl.ROWS)
    assert (a.cg, a.groups, a.fseg, a.fsegs, a.bseg, a.bsegs) == (0,) * 6
    m = 2 * 10 * 20 * 3
    assert a.coef_ssim == -0.2 / (2 * m) and a.coef_l1 == 0.8 / (2 * 20 * 30 * 3)
    assert a.lam == 0.2 and a.c1 == kl.C1 and a.c2 == kl.C2
    g = np.array(a.g[:])
    assert np.array_equal(g.astype(np.float32), g)           # float32 values, exactly
    g = g.astype(np.float32)
    # the window ssim_map uses is the outer product of this Gaussian, which
    # is symmetric bit for bit (the transpose of the window sum needs it)
    assert np.array_equal(g, g[::-1]) and abs(float(g.sum()) - 1.0) < 1e-6
    win = losses._gaussian_window().numpy()
    assert np.array_equal(np.outer(g, g).astype(np.float32), win)
    one = kl.loss_args(pred[0], target[0], 0.5)
    assert (one.b, one.h, one.w, one.c) == (1, 20, 30, 3) and one.pvec == 1


@pytest.mark.parametrize("shape", [(11, 11, 3), (2, 24, 24, 3), (33, 47, 1), (512, 1024, 3)])
def test_the_forward_workspace_aligns_the_slots(shape):
    """The partials, (3, B, H - 10, W - 10, 4) a group of channels, then the
    blocks' slots 16 bytes aligned: a (11, 11, 3) image's twelve float32
    partials end on 16 bytes, a one-channel image's too."""
    *b, h, w, c = shape
    n = 3 * (b[0] if b else 1) * (h - kl.HALO) * (w - kl.HALO) * 4
    for dtype in (torch.float32, torch.float64):
        start, total = kl.workspace(n, dtype, 7)
        assert start >= n and (start * dtype.itemsize) % 16 == 0
        assert (start - n) * dtype.itemsize < 16
        assert (total - start) * dtype.itemsize == 7 * 16
    # an odd count of float32 partials: the slots still start on 16 bytes
    assert kl.workspace(9, torch.float32, 1) == (12, 16)


@pytest.mark.parametrize("shape,view,rows", [
    ((20, 32, 3), "contiguous", True), ((2, 20, 32, 3), "contiguous", True),
    ((20, 32, 1), "contiguous", True), ((20, 30, 2), "contiguous", True),
    ((20, 30, 3), "contiguous", False), ((20, 32, 3), "frame view", False),
    ((20, 32, 3), "unaligned offset", False), ((20, 32, 5), "contiguous", False)])
def test_the_wrapper_stages_target_rows_where_they_are_contiguous(shape, view, rows):
    """Target's rows 16 bytes a copy: channels 1 float apart, pixels C, a
    row's W C floats ending on 16 bytes, 16-byte aligned; else 4 bytes an
    element."""
    t = torch.zeros(shape)
    if view == "frame view":
        t = torch.zeros(shape[:-1] + (4,))[..., :3]
    elif view == "unaligned offset":      # contiguous, 4 bytes past 16
        t = torch.zeros(t.numel() + 1)[1:].view(shape)
    assert kl.stages_rows(t) is rows
    assert kl.loss_args(torch.zeros(shape), t, 0.2).tvec == (kl.ROWS if rows else 0)


def _staging_case(case):
    """(an image, whether the kernels stage its pixels 16 bytes whole)."""
    frame = torch.zeros((2, 20, 30, 4))
    flat = torch.zeros(20 * 30 * 4)
    return {"frame view": (frame[0, ..., :3], True),
            "batched frame view": (frame[..., :3], True),
            "one channel of the frame": (frame[..., :1], True),
            "contiguous rgba": (frame.clone(), True),
            "contiguous rgb": (frame[..., :3].contiguous(), False),
            "unaligned offset": (frame[..., 1:4], False),
            "unaligned rows": (flat.as_strided((19, 30, 3), (122, 4, 1)), False),
            "channels apart": (torch.zeros((2, 20, 3, 30)).permute(0, 1, 3, 2), False),
            # the last pixel's fourth float lies past the storage's end
            "short storage": (torch.zeros(20 * 30 * 4 - 1).as_strided((20, 30, 3), (120, 4, 1)),
                              False),
            "five channels": (torch.zeros((20, 30, 8))[..., :5], False),
            }[case]


@pytest.mark.parametrize("case", ["frame view", "batched frame view", "one channel of the frame",
                                  "contiguous rgba", "contiguous rgb", "unaligned offset",
                                  "unaligned rows", "channels apart", "short storage",
                                  "five channels"])
def test_the_wrapper_chooses_the_staging_path(case):
    t, whole = _staging_case(case)
    assert kl.stages_whole_pixels(t) is whole
    other = torch.zeros(t.shape).contiguous()
    a = kl.loss_args(t, other, 0.2)
    assert a.pvec == (kl.PIXELS if whole else 0)
    assert a.tvec == (kl.ROWS if kl.stages_rows(other) else 0)
    # the strides the kernel reads: batch, row, column, channel
    t4 = t if t.dim() == 4 else t.unsqueeze(0)
    assert tuple(a.ps) == t4.stride()


def _adam_probe():
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_adam_probe.py"
    spec = importlib.util.spec_from_file_location("torch_adam_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_adam_probe_forms_assemble_and_refuse_without_a_card(capsys):
    """Every form of ``scripts/torch_adam_probe.py`` assembles from the
    sources (each edit finds its text), each entry point is in its source,
    and the probe exits 1 where there is no card."""
    probe = _adam_probe()
    for name, (_, _, entry, *_rest) in probe.FORMS.items():
        assert f'extern "C" int {entry}(' in probe.form_source(name), name
    assert set(probe.TURN_FORMS) <= set(probe.FORMS)
    if not torch.cuda.is_available():
        assert probe.main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err
