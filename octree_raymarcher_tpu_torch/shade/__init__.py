from .atlas import default_atlas
from .camera import OrthoCamera, PerspectiveCamera
from .envmap import default_envmap, sample_env
from .lights import DirectionalLight, LightRig, PointLight, Spotlight
from .materials import MaterialTable
from .render import RenderConfig, render, render_frame, shade_hits, shade_hits_plain
from .tiling import block_permutation
