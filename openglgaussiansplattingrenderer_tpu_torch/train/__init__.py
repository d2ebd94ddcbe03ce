from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    TrainState,
    fit_scene,
    make_train_step,
)
from openglgaussiansplattingrenderer_tpu_torch.train.densify import (  # noqa: F401
    DensifyConfig,
    densify_and_prune,
    fit_scene_adaptive,
)
from openglgaussiansplattingrenderer_tpu_torch.train import losses  # noqa: F401
