from .march import MarchResult, march, march_frame, march_plain, march_tiled
from .march_compact import (
    CompactFrameState,
    compact_begin,
    compact_finish,
    compact_stages,
    default_schedule,
    march_frame_compact,
)
