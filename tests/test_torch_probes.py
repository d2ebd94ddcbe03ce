"""The port's two probes on the CPU: the plain versions of their kernels
against straightforward numpy, and the build digest's answer.

The JAX probes (``scripts/bucketer_probe.py``, ``scripts/cache_key_probe.py``)
define their Pallas kernels inside ``main`` and print only times and cache
keys, so there is no JAX function to hold these against: the reference here
is a record-by-record loop of the same semantics. All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.probes import bucketer_probe as bp
from openglgaussiansplattingrenderer_tpu_torch.probes import cache_key_probe as cp


def _bucketer_loop(rec: np.ndarray, k: int) -> np.ndarray:
    n_chunks = rec.shape[1] // bp.R
    out = np.zeros((n_chunks, bp.ROWS, k * bp.CARRY), np.float32)
    for ch in range(n_chunks):
        filled = [0] * k
        for t in range(bp.R):
            col = ch * bp.R + t
            b = int(np.floor(rec[bp.TILE_ROW, col] * np.float32(k / 512.0)))
            if 0 <= b < k:
                if filled[b] < bp.CARRY:
                    out[ch, :, b * bp.CARRY + filled[b]] = rec[:, col]
                filled[b] += 1
    return out


@pytest.mark.parametrize("k", [1, 16, 32, 64])
def test_bucketer_level_plain_matches_a_record_loop(k):
    rec = bp.make_records(bp.R * 4 + 77, "cpu", seed=k)     # a tail no chunk owns
    rec[bp.TILE_ROW, bp.R:2 * bp.R] = 100.0                  # one bucket, 512 deep
    rec[bp.TILE_ROW, 5:9] = torch.tensor([512.0, -1.0, 511.0, 0.0])
    before = bp.bucketer_level.launches
    got = bp.bucketer_level(rec, k)
    assert bp.bucketer_level.launches == before            # CPU: the plain version
    assert got.shape == (4, bp.ROWS, k * bp.CARRY)
    np.testing.assert_array_equal(got.numpy(), _bucketer_loop(rec.numpy(), k))
    # the TPU probe's output is the last chunk's slab
    assert got[-1].shape == (bp.ROWS, k * bp.CARRY)


def test_bucketer_level_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="k must be"):
        bp.bucketer_level(torch.zeros((16, 512)), 65)
    with pytest.raises(ValueError):
        bp.bucketer_level(torch.zeros((9, 512)), 32)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        bp.bucketer_level(torch.zeros((16, 512), device="meta"), 32)
    assert bp.bucketer_level(torch.zeros((16, 100)), 32).shape == (0, 16, 4096)


def test_probe_affine_and_the_digest_of_a_shifted_copy(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32))
    before = cp.probe_affine.launches
    np.testing.assert_array_equal(cp.probe_affine(x).numpy(), x.numpy() * 2.0 + 1.0)
    assert cp.probe_affine.launches == before
    with pytest.raises(TypeError):
        cp.probe_affine(x.double())
    # the digest hashes the sources' bytes: blank lines in front of a kernel
    # change it, though they change no kernel
    assert cp.digest_stable() is False
    copy = cp.shifted_copy(tmp_path / "csrc")
    assert {f.name for f in build.sources(copy)} == {f.name for f in build.sources()}
    assert (copy / "probe_affine.cu").read_text().startswith("\n" * cp.PAD_LINES + "//")
    assert build.digest(copy) != build.digest()
    # without a card the probes refuse to measure
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            cp.run()
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            bp.run(512, 4)
