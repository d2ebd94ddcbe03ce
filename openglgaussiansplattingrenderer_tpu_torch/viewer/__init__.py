from openglgaussiansplattingrenderer_tpu_torch.viewer.offline import (  # noqa: F401
    orbit_cameras,
    render_orbit,
    render_frame,
)
from openglgaussiansplattingrenderer_tpu_torch.viewer import interactive  # noqa: F401
