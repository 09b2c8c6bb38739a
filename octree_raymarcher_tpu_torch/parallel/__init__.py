from .mesh import RAYS_AXIS, RayMesh, init_distributed, local_address, make_mesh
from .render_sharded import (
    make_sharded_train_step,
    make_zero_train_step,
    march_sharded,
    march_sharded_compact,
    pad_rays,
    render_frame_sharded,
    render_sharded,
)
