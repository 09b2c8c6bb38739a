from .scene import VoxelScene
