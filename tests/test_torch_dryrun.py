"""The port's multi-device dry run (``dryrun.py``) on CPU shards: every
phase runs and passes its own checks (finite losses and updates, no
dropped record, renormalised quaternions, a densify that grows the set);
with fewer than four shards the 2-D phases are left out."""

import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu_torch.dryrun import dryrun_multichip
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, capsys):
    out = dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out
    assert out["devices"] == ["cpu"] * n
    assert np.isfinite(out["sharded_step_loss"]) and np.isfinite(out["dp_step_loss"])
    if n >= 4:
        assert "one 2-D (2x2) view-x-splat step ok" in line
        assert np.isfinite(out["mesh2d_step_loss"]) and out["mesh2d_fit_alive"] > 48
    else:
        assert "2-D" not in line and "mesh2d_step_loss" not in out


def test_dryrun_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
