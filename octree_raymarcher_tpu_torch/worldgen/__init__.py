from .pyramid import BoundsPyramid
from .grow import grow, height_material
from .simplex import permutation_table, simplex2
