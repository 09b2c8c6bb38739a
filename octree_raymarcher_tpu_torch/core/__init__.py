from . import constants
from .chunk import Chunk, Dirty
from .nodes import (
    BRANCH, EMPTY, LEAF, TWIG,
    branch_cut, branch_index, node_payload, node_type, pack, pack_scalar, twig_word,
)
