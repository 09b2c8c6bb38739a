from .metrics import Collectives, Counter, MetricsLogger, clear_spans, span, span_records
from .png import load_png, save_png
