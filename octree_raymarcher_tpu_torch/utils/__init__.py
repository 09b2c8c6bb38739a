from .metrics import Counter, MetricsLogger, rays_per_second
from .png import load_png, save_png
