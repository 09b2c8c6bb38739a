from .composite import VoxelParams, composite, init_params_from_world, render_soft
from .optim import fit, make_loss_fn
from .segments import (
    SegmentBatch,
    num_param_slots,
    sample_segments,
    sample_segments_frame,
    sample_segments_ref,
)
from .segments_compact import sample_segments_compact
from .checkpoint import save_state, load_state
