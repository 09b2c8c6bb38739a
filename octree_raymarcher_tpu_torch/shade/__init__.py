from .atlas import (atlas_from_sheet, default_atlas, load_atlas_png, save_atlas_png,
                    sheet_from_atlas)
from .camera import OrthoCamera, PerspectiveCamera
from .envmap import default_envmap, sample_env
from .lights import DirectionalLight, LightRig, PointLight, Spotlight
from .materials import MaterialTable
from .render import (
    RenderConfig,
    map_shadow,
    ray_shadow,
    render,
    render_frame,
    render_shadowmap,
    shade_hits,
    shade_hits_plain,
    shadow_bundle,
)
from .tiling import block_permutation
