from .device import (PackedWorld, TorchWorld, occupancy_masks, pack_chunks, resolve_device,
                     single_chunk_world)
from .alloc import FreeList, PoolAllocator, WorldAllocator
from .edit import build, destroy, replace
from .world import World
from .lod import defrag, lod
from .pick import PickResult, cursor_box, pick
