"""Isolation and device rules of the port.

- The port, ``chip_smoke.py``, ``tools/torch_*.py`` and
  ``examples/torch_*.py`` import neither JAX,
  flax nor any module of ``objectdetection_tpu`` (checked in a fresh
  interpreter, and by a scan of the sources).
- No port module imports ``cv2``, ``PIL`` or ``h5py`` at module level (the
  card's machine has no ``cv2`` and no ``h5py``): the h5 loader and the
  decoder's Pillow branch import them inside the function that needs them.
- Entry points default to the card: with no card they raise instead of
  running on the CPU (``parallel.initialize_multihost`` and ``make_mesh``
  too, before starting a process group); ``device="cpu"`` runs on the CPU.
- Unported options raise instead of falling back: the int8 path serves
  but does not train, and a flax collection the port does not know is
  refused (bias correction's ``stats`` is ported and crosses over).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from objectdetection_torch import convert, detector, parallel
from objectdetection_torch.config import SHAPES_CONFIG

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "objectdetection_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "objectdetection_tpu")


def port_modules():
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py",
                                       *(ROOT / "tools").glob("torch_*.py"),
                                       *(ROOT / "examples").glob("torch_*.py")]))
def test_sources_import_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


OPTIONAL = ("cv2", "PIL", "h5py")


def imported_names(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        return [node.module or ""]
    return []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")))
def test_no_optional_package_at_module_level(path):
    tree = ast.parse((ROOT / path).read_text())
    # module-level statements, also inside a module-level if / try
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.If, ast.Try)):
            stack += node.body + node.orelse + getattr(node, "finalbody", [])
            stack += [s for h in getattr(node, "handlers", []) for s in h.body]
        for name in imported_names(node):
            assert name.split(".")[0] not in OPTIONAL, f"{path}: imports {name} at module level"


def test_serving_modules_import_without_optional_packages():
    # the server's whole path, in an interpreter where cv2, PIL and h5py fail
    code = (
        "import sys\n"
        f"for m in {OPTIONAL!r}: sys.modules[m] = None\n"
        "import numpy as np\n"
        "from objectdetection_torch import checkpoint, cli, serve, viz\n"
        "from objectdetection_torch.data import image_io, masks, preprocess\n"
        "img = (np.arange(5 * 7 * 3) % 256).astype(np.uint8).reshape(5, 7, 3)\n"
        "assert (image_io.decode_image(image_io.encode_png(img)) == img).all()\n"
        "try:\n"
        "    image_io.decode_image(b'GIF89a')\n"
        "except image_io.ImageDecodeError as e:\n"
        "    assert 'Pillow is not installed' in str(e), e\n"
        "else:\n"
        "    sys.exit('no error')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_the_card():
    cfg = SHAPES_CONFIG.replace(compute_dtype="float32")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        detector.make_infer_fn(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.initialize_multihost()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()
    assert not dist.is_initialized()
    assert detector.make_infer_fn(cfg, device="cpu") is not None


def test_quantized_inference_raises_not_implemented():
    # the int8 path builds and serves on the CPU; what it does not do raises
    cfg = SHAPES_CONFIG.replace(quantized_inference=True)
    params = convert.init_params(cfg, device="cpu")
    assert params["fpn.resnet.res2a.res2a_branch2a.act_scale"].shape == ()
    assert params["pooled_box_scale"].shape == ()
    assert detector.make_infer_fn(cfg, device="cpu") is not None
    with pytest.raises(NotImplementedError, match="serving"):
        detector.make_train_step(cfg, device="cpu")
    sd = convert.flax_to_state_dict({
        "params": {"conv": {"kernel": np.ones((1, 1, 2, 3), np.int8)}},
        "quant": {"conv": {"act_scale": np.float32(2.0), "kernel_scale": np.ones(3, np.float32)}},
    })
    assert sd["conv.weight"].dtype == torch.int8 and sd["conv.weight"].shape == (3, 2, 1, 1)
    assert sd["conv.act_scale"].shape == ()
    params, stats, quant = convert.split_collections(sd)
    assert set(quant) == {"conv.act_scale", "conv.kernel_scale"} and set(params) == {"conv.weight"}
    # sow leaves a tuple per module; the last value is the one JAX's correction reads
    means = convert.flax_to_state_dict({"stats": {"conv": {"act_mean": (
        np.zeros(2, np.float32), np.full(2, 3.0, np.float32))}}})
    assert set(means) == {"conv.act_mean"} and means["conv.act_mean"].tolist() == [3.0, 3.0]
    with pytest.raises(NotImplementedError, match="intermediates"):
        convert.flax_to_state_dict({"params": {}, "intermediates": {}})


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
