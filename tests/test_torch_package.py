"""Package rules of the PyTorch port.

* No module of the port (nor chip_smoke.py) imports jax, flax, optax or the
  JAX package ``octree_raymarcher_tpu`` (an AST scan, and a fresh
  interpreter that imports every module and then inspects sys.modules).
* Entry points raise without a GPU unless ``device="cpu"`` is given.
* On CPU tensors the kernel launch counters stay at 0, and importing the
  package builds nothing.
* The ctypes argument lists match the C entry points in csrc/.
"""

import ast
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import octree_raymarcher_tpu_torch as port
from octree_raymarcher_tpu_torch import demo, entry, kernels
from octree_raymarcher_tpu_torch.models import VoxelScene
from octree_raymarcher_tpu_torch.ops.guards import march_checked
from octree_raymarcher_tpu_torch.parallel import init_distributed, local_address
from octree_raymarcher_tpu_torch.ops.march import MARCH_KERNEL, march, march_frame
from octree_raymarcher_tpu_torch.shade.render import SHADE_KERNEL, render, render_frame
from octree_raymarcher_tpu_torch.world.alloc import PATCH_KERNEL, WorldAllocator
from octree_raymarcher_tpu_torch.world.device import TorchWorld
from octree_raymarcher_tpu_torch.world.world import World

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(port.__file__).resolve().parent
# `octree_raymarcher_tpu` followed by ".", a space or the end: not `_torch`.
FORBIDDEN = re.compile(r"^(jax|flax|optax|octree_raymarcher_tpu)(\.|\s|$)")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_pattern():
    assert FORBIDDEN.match("octree_raymarcher_tpu.ops")
    assert FORBIDDEN.match("octree_raymarcher_tpu")
    assert FORBIDDEN.match("jax.numpy")
    assert not FORBIDDEN.match("octree_raymarcher_tpu_torch.ops")
    assert not FORBIDDEN.match("jaxlib_free")


def test_no_reference_imports_ast():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_names(f) if FORBIDDEN.match(name)]
    assert not bad, bad


def test_no_reference_modules_loaded():
    mods = sorted(m.name for m in
                  pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import re\n"
        "pat = re.compile(r'^(jax|flax|optax|octree_raymarcher_tpu)(\\.|$)')\n"
        "bad = sorted(m for m in sys.modules if pat.match(m))\n"
        "from octree_raymarcher_tpu_torch import kernels\n"
        "assert kernels._lib is None\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert len(mods) >= 15


def test_multi_gpu_scene_and_guard_modules_import_without_jax():
    """The sharded paths, the scene, the entry twin and the guards are
    walked by the scan above and import in a fresh interpreter with no JAX."""
    mods = [f"octree_raymarcher_tpu_torch.{m}" for m in (
        "parallel", "parallel.mesh", "parallel.render_sharded", "models", "models.scene",
        "entry", "ops.guards")]
    walked = {m.name for m in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + ".")}
    assert set(mods) <= walked
    code = (
        "import importlib, re, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "pat = re.compile(r'^(jax|flax|optax|octree_raymarcher_tpu)(\\.|$)')\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('BAD', sorted(m for m in sys.modules if pat.match(m)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.fixture
def tiny():
    """A small world, its packed pools, and a few rays."""
    w = World.generate(dims=(1, 1, 1), chunksize=16.0, depth=3, seed=1,
                       water_level=2.0, amplitude=8.0)
    o = np.tile(np.float32([[8.0, 30.0, -5.0]]), (16, 1))
    d = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return w, o, d


def test_entry_points_raise_without_gpu(tiny, monkeypatch):
    w, o, d = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_world = w.to_torch(device="cpu")
    wa, cpu_alloc_world = w.to_device(device="cpu")
    eye = o[0]
    for call in (
        lambda: w.to_torch(),
        lambda: TorchWorld.from_numpy(w.pack()),
        lambda: w.to_device(),
        lambda: WorldAllocator.pack(w.chunks, w.dims),
        lambda: demo.run_session(w, wa, cpu_alloc_world, frames=1, res=(8, 4)),
        lambda: demo.main(["--frames", "1", "--res", "8x4", "--dims", "1x1x1",
                           "--depth", "3", "--out", "unused"]),
        lambda: march(cpu_world, o, d),
        lambda: march_frame(cpu_world, o, d),
        lambda: render(cpu_world, o, d, eye),
        lambda: render_frame(cpu_world, o, d, eye),
        lambda: kernels.library(),
        lambda: VoxelScene.demo(16.0, 4, 3),
        lambda: entry.entry(),
        lambda: march_checked(cpu_world, o, d),
        lambda: init_distributed(local_address(), 1, 0),
    ):
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            call()
    # with device="cpu" the plain versions run
    out = render_frame(cpu_world, o, d, eye, device="cpu")
    assert out["rgb"].shape == (16, 3) and out["hit"].any()
    assert march(cpu_world, o, d, device="cpu").hit.shape == (16,)


def test_world_dtypes_checked(tiny):
    w, o, d = tiny
    world = w.to_torch("cpu")
    world.tree = world.tree.to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        march(world, o, d, device="cpu")


def test_cpu_path_launches_no_kernel(tiny):
    w, o, d = tiny
    world = w.to_torch("cpu")
    before = (MARCH_KERNEL.launches, SHADE_KERNEL.launches, PATCH_KERNEL.launches)
    render(world, o, d, o[0], device="cpu")
    march(world, o, d, steps_aov=True, device="cpu")
    wa, edited = w.to_device(device="cpu")
    edited = w.apply(wa, edited, w.destroy((2.0, 0.0, 2.0), (9.0, 16.0, 9.0)))
    assert wa.last_batch is not None and wa.last_batch.chunks == 1
    assert (MARCH_KERNEL.launches, SHADE_KERNEL.launches,
            PATCH_KERNEL.launches) == before == (0, 0, 0)
    assert kernels._lib is None


def test_ctypes_signatures_match_sources():
    """Each C entry point's parameter count equals its ctypes argtypes
    (the last one is the stream, which the wrapper appends)."""
    src = "\n".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu")))
    found = {name: params for name, params in
             re.findall(r"^int (ort_\w+)\(([^)]*)\)", src, flags=re.M)}
    assert set(found) == set(kernels.SIGNATURES)
    for name, params in found.items():
        n_params = len([p for p in params.split(",") if p.strip()])
        assert n_params == len(kernels.SIGNATURES[name]), name
        assert params.split(",")[-1].strip() == "void* stream", name


def test_table_layouts_match_shade_kernel():
    """The light-vector slots and material-row columns that shade.cu reads
    are where LightRig.to_vector and MaterialTable.to_matrix put them."""
    from octree_raymarcher_tpu_torch.shade.lights import VECTOR_LAYOUT, LightRig
    from octree_raymarcher_tpu_torch.shade.materials import MaterialTable

    src = (kernels.CSRC / "shade.cu").read_text()
    enum = src[src.index("enum LightSlot"):src.index("};", src.index("enum LightSlot"))]
    slots = sorted(int(v) for v in re.findall(r"= (\d+)", enum))
    offsets = np.cumsum([0] + [w for _, _, w in VECTOR_LAYOUT])
    assert slots == offsets[:-1].tolist()
    assert LightRig.default().to_vector().shape == (offsets[-1],) == (50,)
    cols = dict(re.findall(r"(kMat\w+) = (\d+)", src))
    assert cols == {"kMatStride": "10", "kMatDif": "3", "kMatSpec": "6", "kMatShin": "9"}
    m = MaterialTable.default().to_matrix()
    assert m.shape[1] == 10
    torch.testing.assert_close(m[:, 9], MaterialTable.default().shininess)
