from openglgaussiansplattingrenderer_tpu_torch.io.ply import (  # noqa: F401
    PlyData,
    load_ply,
    load_splats,
    save_ply,
    make_synthetic_scene,
    make_clustered_scene,
    single_splat_scene,
    red_splat_scene,
)
from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png, load_png  # noqa: F401
