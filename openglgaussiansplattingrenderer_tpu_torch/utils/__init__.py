from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (  # noqa: F401
    FrameTimer,
    fence,
    span,
)
