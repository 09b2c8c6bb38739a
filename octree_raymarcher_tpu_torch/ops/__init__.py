from .march import MarchResult, march, march_frame, march_plain, march_tiled
