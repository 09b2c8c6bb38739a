from .device import PackedWorld, TorchWorld, occupancy_masks, pack_chunks, resolve_device
from .edit import build, destroy, replace
from .world import World
