"""The port's radix sort on the CPU (the plain versions of its two kernels)
against the JAX package's Pallas radix sort in interpret mode and against
``torch.sort(stable=True)``.

Every comparison is exact, no tolerance: the chunk count table at 4-bit
digits against ``_histogram``, the chunk offsets that the scatter's
look-back gives against the JAX ``_prefix_offsets``, and the five cases of
``tests/test_radix_sort.py`` at both digit widths and at two chunk lengths
(one chunk, and several with a ragged last one).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.ops.pallas import radix_sort as jax_rx

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _bits_of(u32: np.ndarray) -> torch.Tensor:
    """numpy uint32 -> the int32 tensor of the same bits."""
    return torch.from_numpy(u32.view(np.int32).copy())


def _u32_of(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def test_hist_plain_matches_the_pallas_histogram():
    # the JAX kernel counts 512-key chunks of a key held as two 16-bit f32
    # halves; the plain version counts the same chunks of the u32 itself
    c = 4096
    keys = np.random.default_rng(0).integers(0, 2 ** 32, c, dtype=np.uint32)
    rec = np.zeros((8, c), np.float32)
    rec[0], rec[1] = keys >> 16, keys & 0xFFFF
    for bit0 in range(0, 32, 4):
        want = jax_rx._histogram(
            jnp.asarray(rec), key_row=1 if bit0 < 16 else 0, shift=bit0 % 16,
            n_chunks=c // jax_rx.R, nr=8)[:, :16]
        got = rx.radix_hist_plain(_bits_of(keys), bit0, 4, chunk=jax_rx.R)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("n_chunks", [1, 8, 37])
def test_prefix_offsets_match_jax(n_chunks):
    # the offsets the scatter builds from the pass's counts (global digit
    # bases) and the chunks before it, against the JAX table of the chunks'
    # counts, at the JAX package's 512-key chunks and 4-bit digits
    c = n_chunks * jax_rx.R - 3
    keys = _bits_of(np.random.default_rng(n_chunks).integers(0, 2 ** 32, c,
                                                             dtype=np.uint32))
    counts = rx.radix_counts(keys, 32, 4)
    for p in range(8):
        hist = rx.radix_hist_plain(keys, 4 * p, 4, chunk=jax_rx.R)
        want = jax_rx._prefix_offsets(jnp.asarray(hist.numpy()))
        got = rx.chunk_offsets_plain(keys, counts[p], 4 * p, 4, chunk=jax_rx.R)
        assert got.dtype == torch.int32 and got.shape == (n_chunks + 1, 16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("n_chunks", [1, 8, 37])
def test_prefix_offsets_plain_matches_jax_and_numpy(n_chunks, k):
    counts = np.random.default_rng(n_chunks * k).integers(
        0, 4097, (n_chunks, k)).astype(np.int32)
    got = rx._prefix_offsets_plain(torch.from_numpy(counts))
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.shape == (n_chunks + 1, k)
    if k == 16:                                  # the JAX package's digit width
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_rx._prefix_offsets(jnp.asarray(counts))))
    # digit-major: all of digit 0's chunks, then digit 1's, ...
    incl = np.cumsum(counts.T.reshape(-1), dtype=np.int64).reshape(k, n_chunks)
    np.testing.assert_array_equal(got.numpy()[:-1], (incl - counts.T).T)
    np.testing.assert_array_equal(got.numpy()[-1], incl[:, -1])
    # whatever the strides of the table
    t = torch.from_numpy(np.ascontiguousarray(counts.T)).t()
    assert not t.is_contiguous() or 1 in t.shape
    assert torch.equal(rx._prefix_offsets_plain(t), got)


def test_prefix_offsets_checks_raise_what_they_say():
    # the offsets come from the pass's row of the counts, which the scatter
    # checks; an empty table has its closing row alone
    assert torch.equal(rx._prefix_offsets_plain(torch.zeros((0, 16), dtype=torch.int32)),
                       torch.zeros((1, 16), dtype=torch.int32))
    keys = torch.zeros(64, dtype=torch.int32)
    vals = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        rx.radix_scatter(keys, vals, torch.zeros(256, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="counts"):
        rx.radix_scatter(keys, vals, torch.zeros((1, 256), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="counts"):
        rx.radix_scatter(keys, vals, torch.zeros(16, dtype=torch.int32), 0, 8)
    with pytest.raises(ValueError, match="exceed int32 offsets"):
        rx.radix_sort(torch.empty(2 ** 31, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        rx.radix_scatter(keys, vals, torch.empty(256, dtype=torch.int32, device="meta"), 0)


def _case(name):
    """(u32 keys, payload rows, key_bits) of one case of tests/test_radix_sort.py."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "full_32bit_keys":
        c = 3000
        return (rng.integers(0, 2 ** 32, c, dtype=np.uint32),
                [rng.standard_normal(c).astype(np.float32) for _ in range(3)], 32)
    if name == "duplicate_keys":
        c = 2048
        return (rng.integers(0, 7, c, dtype=np.uint32),
                [np.arange(c, dtype=np.float32)], 4)
    if name == "key_bits_9":
        c = 1500
        return (rng.integers(0, 512, c, dtype=np.uint32),
                [rng.standard_normal(c).astype(np.float32)], 9)
    assert name == "extreme_keys"
    return (np.array([0xFFFFFFFF, 0, 0xFFFFFFFF, 123456789, 0xFFFFFFFE], np.uint32),
            [np.arange(5, dtype=np.float32)], 32)


CASES = ["full_32bit_keys", "duplicate_keys", "key_bits_9", "extreme_keys"]


@functools.lru_cache(maxsize=None)
def _jax_sorted(name):
    keys, vals, key_bits = _case(name)
    sk, sv = jax_rx.radix_sort(jnp.asarray(keys), tuple(map(jnp.asarray, vals)),
                               key_bits=key_bits)
    return np.asarray(sk), [np.asarray(v) for v in sv]


@pytest.mark.parametrize("chunk", [512, 4096])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name", CASES)
def test_radix_sort_matches_jax_and_torch_sort(name, bits, chunk, monkeypatch):
    monkeypatch.setattr(rx, "CHUNK", chunk)
    keys, vals, key_bits = _case(name)
    before = (rx.radix_counts.launches, rx.radix_scatter.launches)
    sk, sv = rx.radix_sort(_bits_of(keys), [torch.from_numpy(v) for v in vals],
                           key_bits, bits)
    assert (rx.radix_counts.launches, rx.radix_scatter.launches) == before
    assert sk.dtype == torch.int32 and all(v.dtype == torch.float32 for v in sv)
    want_k, want_v = _jax_sorted(name)
    np.testing.assert_array_equal(_u32_of(sk), want_k)
    for a, b in zip(sv, want_v):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), b.view(np.uint32))
    rk, ri = torch.sort(torch.from_numpy(keys.astype(np.int64)), stable=True)
    np.testing.assert_array_equal(_u32_of(sk).astype(np.int64), rk.numpy())
    for a, v in zip(sv, vals):
        np.testing.assert_array_equal(a.numpy(), v[ri.numpy()])
    if name == "extreme_keys":
        np.testing.assert_array_equal(sv[0].numpy(), [1.0, 3.0, 4.0, 0.0, 2.0])


def test_radix_sort_takes_uint32_and_int32_payloads():
    keys, _, _ = _case("full_32bit_keys")
    idx = torch.arange(keys.shape[0], dtype=torch.int32)
    sk, (si,) = rx.radix_sort(torch.from_numpy(keys.view(np.int32)).view(torch.uint32),
                              (idx,), 32)
    assert sk.dtype == torch.uint32 and si.dtype == torch.int32
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(_u32_of(sk), keys[order])
    np.testing.assert_array_equal(si.numpy(), order.astype(np.int32))
    assert rx.radix_sort(torch.zeros(0, dtype=torch.int32))[0].shape == (0,)
    with pytest.raises(ValueError, match="int32"):
        rx.radix_sort(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="32-bit"):
        rx.radix_sort(torch.zeros(4, dtype=torch.int32), (torch.zeros(4).double(),))
    with pytest.raises(ValueError, match="4 or 8"):
        rx.radix_sort(torch.zeros(4, dtype=torch.int32), bits=5)


@functools.lru_cache(maxsize=None)
def _grad_case():
    """(keys, payload, weights, jax.grad of sum(sorted payload * weights))."""
    rng = np.random.default_rng(1234)
    c = 640
    keys = rng.integers(0, 2 ** 20, c, dtype=np.uint32)
    v = rng.standard_normal(c).astype(np.float32)
    w = rng.standard_normal(c).astype(np.float32)

    def loss(x):
        _, _, sf = jax_rx.radix_sort_with_payload(jnp.asarray(keys), (x,), 20)
        return jnp.sum(sf[0] * jnp.asarray(w))

    return keys, v, w, np.asarray(jax.grad(loss)(jnp.asarray(v)))


@pytest.mark.parametrize("bits", [4, 8])
def test_radix_sort_with_payload_grad(bits, monkeypatch):
    # the cotangent comes back un-permuted, exactly as jax.grad has it
    monkeypatch.setattr(rx, "BITS", bits)
    keys, v, w, want = _grad_case()
    c = keys.shape[0]
    fields = torch.from_numpy(v)[None, :].requires_grad_(True)
    sk, si, sf = rx.radix_sort_with_payload(_bits_of(keys), fields, 20)
    assert si.dtype == torch.int32 and not sk.requires_grad and not si.requires_grad
    (got,) = torch.autograd.grad((sf[0] * torch.from_numpy(w)).sum(), fields)
    np.testing.assert_array_equal(got[0].numpy(), want)
    expect = np.zeros(c, np.float32)
    expect[si.numpy()] = w
    np.testing.assert_array_equal(got[0].numpy(), expect)
    np.testing.assert_array_equal(si.numpy(), np.argsort(keys, kind="stable"))


def test_radix_sort_300k_keys_through_the_plain_versions():
    # 74 chunks of 4,096 with a ragged last one, four 8-bit passes
    c = 300_000
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2 ** 32, c, dtype=np.uint32)
    keys[1000:3000] = keys[0]                                # a long tie
    idx = torch.arange(c, dtype=torch.int32)
    sk, (si,) = rx.radix_sort(_bits_of(keys), (idx,), 32)
    rk, ri = torch.sort(torch.from_numpy(keys.astype(np.int64)), stable=True)
    assert torch.equal(kr.u32_values(sk), rk)
    assert torch.equal(si.to(torch.int64), ri)


def test_radix_sort_has_no_size_ceiling():
    # the JAX sort raises above 2M keys (its offset table must fit SMEM)
    c = 2_500_000
    keys = torch.from_numpy(
        np.random.default_rng(3).integers(0, 16, c, dtype=np.int32))
    with pytest.raises(ValueError, match="SMEM offset table"):
        jax_rx.radix_sort(jnp.zeros(c, jnp.uint32), (), key_bits=8)
    sk, () = rx.radix_sort(keys, (), key_bits=4, bits=4)
    assert torch.equal(sk, torch.sort(keys).values)


def test_radix_wrappers_take_the_plain_version_only_on_cpu():
    keys = torch.zeros(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        rx.radix_counts(keys)
    vals = torch.zeros((1, 10), dtype=torch.int32, device="meta")
    counts = torch.zeros(256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        rx.radix_scatter(keys, vals, counts, 0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        rx.radix_sort(keys)
    with pytest.raises(TypeError):
        rx.radix_counts(torch.zeros(10, dtype=torch.int64))
    with pytest.raises(ValueError, match="leaves the key"):
        rx.radix_scatter(torch.zeros(10, dtype=torch.int32),
                         torch.zeros((1, 10), dtype=torch.int32),
                         torch.zeros(256, dtype=torch.int32), 28, 8)
    with pytest.raises(ValueError, match="key_bits"):
        rx.radix_counts(torch.zeros(10, dtype=torch.int32), 33)
    with pytest.raises(ValueError):                         # counts of another width
        rx.radix_scatter(torch.zeros(10, dtype=torch.int32),
                         torch.zeros((1, 10), dtype=torch.int32),
                         torch.zeros((3, 256), dtype=torch.int32), 0)
