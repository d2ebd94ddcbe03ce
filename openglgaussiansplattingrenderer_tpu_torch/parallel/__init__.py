"""Multi-device rendering and training on a single-controller mesh: an
explicit list of devices (``sharded.Mesh``), one Python loop over the
shards, collectives that autograd differentiates. ``sharded`` holds the
mesh, the collectives and the oracle; ``fast_sharded`` the kernels' path
with a record exchange by tile owner; ``data_parallel`` view-parallel
training with replicated parameters."""

from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_scene_for_mesh,
    render_sharded,
    shard_params,
    sharded_train_step,
)
