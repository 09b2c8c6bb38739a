from . import cpu_ref
