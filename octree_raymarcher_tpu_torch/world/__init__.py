from .device import (PackedWorld, TorchWorld, occupancy_masks, pack_chunks, resolve_device,
                     single_chunk_world)
from .edit import build, destroy, replace
from .world import World
