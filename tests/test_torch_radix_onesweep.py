"""The onesweep shape of the port's radix sort, on the CPU.

``csrc/radix_sort.cu`` counts every pass's digits in one launch
(``radix_counts``) and gives each scatter chunk its base per digit by
decoupled look-back over the chunks before it. The kernels run only on a
card; here their arithmetic is held, exactly, against the JAX package:

- ``radix_counts_plain`` against the column sums of the JAX ``_histogram``
  (4-bit digits, in interpret mode) and against a numpy count (8 bits);
- a numpy model of the look-back, step for step as the kernel takes it
  (a thread a digit publishes its chunk's count, reads four descriptors
  back at a time, nearest first, reads a chunk that has published nothing
  again, stops at the nearest prefix and publishes its own), with the
  chunks' steps run in random orders, against ``_prefix_offsets_plain``,
  the JAX ``_prefix_offsets`` and ``chunk_offsets_plain``;
- the plain passes fed by those bases against ``torch.sort(stable=True)``.

Key sets: constant keys, one key a digit, sorted, reversed, fewer keys than
a chunk, one whole chunk, and k chunks and one key.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.ops.pallas import radix_sort as jax_rx

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx

CHUNK = rx.CHUNK
EMPTY, SUM, PREFIX = 0, 1, 2       # a descriptor's status, as in the kernel
LOOK = 4                           # descriptors a look-back step reads


def _keys(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n + len(kind))
    if kind == "constant":
        return np.full(n, 0xA5C3E1F7, np.uint32)
    if kind == "one_a_digit":          # every byte walks all 256 digits
        return (np.arange(n, dtype=np.uint32) % 256) * np.uint32(0x01010101)
    rnd = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    if kind == "sorted":
        return np.sort(rnd)
    assert kind == "reversed"
    return np.sort(rnd)[::-1].copy()


def _bits_of(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.view(np.int32).copy())


def look_back_model(hist: np.ndarray, counts: np.ndarray, rng) -> tuple:
    """The chunks' bases as the scatter's look-back finds them.

    ``hist`` (n_chunks, K) is each chunk's count of each digit (phase A),
    ``counts`` (K,) the pass's counts over all keys (``radix_counts``).
    At each step one chunk, drawn at random among those not done, takes its
    next step: publish its counts (the first chunk as its prefix), or read
    LOOK descriptors back from the nearest chunk it has not summed. The
    chains of the K digits are independent and a block's threads publish
    together, so a chunk steps for all its digits at once. Returns
    ((n_chunks + 1, K) offsets, the chains that summed a published count
    before they met a prefix, the chains that met a prefix first)."""
    n_chunks, k = hist.shape
    status = np.full(n_chunks, EMPTY)
    value = np.zeros((n_chunks, k), np.int64)
    cursor = np.arange(n_chunks) - 1            # the nearest chunk not summed
    before = np.zeros((n_chunks, k), np.int64)
    summed = np.zeros(n_chunks, bool)
    done = np.zeros(n_chunks, bool)
    through_sums = at_once = 0
    while not done.all():
        c = int(rng.choice(np.flatnonzero(~done)))
        if status[c] == EMPTY:
            status[c] = PREFIX if c == 0 else SUM
            value[c] = hist[c]
            done[c] = c == 0
            continue
        for _ in range(LOOK):
            at = cursor[c]
            st = PREFIX if at < 0 else status[at]
            if st == EMPTY:
                break                           # read again at a later step
            if at >= 0:
                before[c] += value[at]
            if st == PREFIX:
                status[c], value[c], done[c] = PREFIX, before[c] + hist[c], True
                through_sums += int(summed[c])
                at_once += int(not summed[c])
                break
            summed[c] = True
            cursor[c] -= 1
    base = np.cumsum(counts) - counts           # the digit's global base
    offs = np.concatenate([base + before, (base + counts)[None, :]])
    return offs.astype(np.int32), through_sums, at_once


KINDS = ["constant", "one_a_digit", "sorted", "reversed"]
SIZES = [CHUNK - 1000, CHUNK, 3 * CHUNK + 1]


@functools.lru_cache(maxsize=None)
def _jax_counts(kind: str, n: int) -> np.ndarray:
    """Column sums of the JAX _histogram at the first and the last 4-bit
    digit: (2, 16)."""
    keys = _keys(kind, n)
    c = -(-n // (jax_rx.R * jax_rx.HC)) * jax_rx.R * jax_rx.HC
    rec = np.zeros((8, c), np.float32)
    rec[0, :n], rec[1, :n] = keys >> 16, keys & 0xFFFF
    out = []
    for bit0 in (0, 28):
        h = np.asarray(jax_rx._histogram(
            jnp.asarray(rec), key_row=1 if bit0 < 16 else 0, shift=bit0 % 16,
            n_chunks=c // jax_rx.R, nr=8))[:, :16].astype(np.int64)
        out.append(h.sum(0))
    out = np.stack(out)
    out[:, 0] -= c - n                   # the zero keys that pad the JAX rows
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_radix_counts_plain_matches_the_jax_histogram_and_numpy(kind):
    n = 3 * CHUNK + 1
    keys = _keys(kind, n)
    got4 = rx.radix_counts_plain(_bits_of(keys), 32, 4)
    assert got4.dtype == torch.int32 and got4.shape == (8, 16)
    np.testing.assert_array_equal(got4.numpy()[[0, 7]], _jax_counts(kind, n))
    np.testing.assert_array_equal(got4.numpy(), np.stack(
        [np.bincount((keys >> s) & 0xF, minlength=16) for s in range(0, 32, 4)]))
    got8 = rx.radix_counts_plain(_bits_of(keys), 32, 8)
    want8 = np.stack([np.bincount((keys >> s) & 0xFF, minlength=256)
                      for s in (0, 8, 16, 24)])
    np.testing.assert_array_equal(got8.numpy(), want8)
    # fewer passes where the key range is shorter: 10 bits are two 8-bit passes
    np.testing.assert_array_equal(
        rx.radix_counts_plain(_bits_of(keys & 0x3FF), 10, 8).numpy(), np.stack(
            [np.bincount((keys & 0x3FF) >> s & 0xFF, minlength=256) for s in (0, 8)]))
    # the dispatching wrapper takes the plain version on CPU tensors
    assert torch.equal(rx.radix_counts(_bits_of(keys), 32, 8), got8)


@pytest.mark.parametrize("chunk", [CHUNK, 512])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_look_back_model_gives_the_prefix_offsets(kind, n, bits, chunk):
    # the port's 4,096-key chunks, and the JAX package's 512, which give the
    # random orders more chunks to interleave
    keys = _bits_of(_keys(kind, n))
    counts = rx.radix_counts_plain(keys, 32, bits)
    rng = np.random.default_rng(n * bits + len(kind) + chunk)
    k, v = keys, torch.arange(n, dtype=torch.int32)[None, :]
    through_sums = at_once = 0
    for p in range(32 // bits):
        shift = p * bits
        hist = rx.radix_hist_plain(k, shift, bits, chunk)
        got, sums, once = look_back_model(hist.numpy(), counts[p].numpy(), rng)
        through_sums, at_once = through_sums + sums, at_once + once
        np.testing.assert_array_equal(got, rx._prefix_offsets_plain(hist).numpy())
        np.testing.assert_array_equal(
            got, rx.chunk_offsets_plain(k, counts[p], shift, bits, chunk).numpy())
        if (bits, chunk, p) == (4, 512, 0):    # the JAX digit width and chunk
            np.testing.assert_array_equal(
                got, np.asarray(jax_rx._prefix_offsets(jnp.asarray(hist.numpy()))))
        k, v = rx.radix_scatter_plain(k, v, torch.from_numpy(got), shift, bits, chunk)
    want_k, want_i = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF, stable=True)
    assert torch.equal(k.to(torch.int64) & 0xFFFFFFFF, want_k)
    assert torch.equal(v[0].to(torch.int64), want_i)
    if n > 2 * chunk:
        # the random orders ran both kinds of chain: through published counts
        # to a prefix, and straight onto a prefix
        assert through_sums > 0 and at_once > 0, (through_sums, at_once)
