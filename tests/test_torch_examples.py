"""The port's two examples against the JAX package's.

Each example runs as a subprocess with ``--device cpu`` (one thread), exits
0 and prints its lines in the formats of ``examples/quickstart.py`` and
``examples/visualize_rpn_targets.py``. The RPN-target example's counts equal
those of JAX's ``rpn_targets`` on the same image (at seed 7 the positives,
4, are below the sampling budget's half, so their count does not depend on
the draw, and the negatives fill the rest), and the PNG it writes decodes at
128 x 128. Without a card the examples' default device raises.
"""

import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.anchors import config_anchors
from objectdetection_tpu.config import SHAPES_CONFIG
from objectdetection_tpu.data.shapes import ShapesDataset
from objectdetection_tpu.layers.targets import rpn_targets

from objectdetection_torch.data import image_io

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def run_example(name, *args, cwd=None):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(ROOT / "examples" / name), *args],
                          cwd=cwd or ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_quickstart_trains_and_infers_on_the_cpu():
    proc = run_example("torch_quickstart.py", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 7, lines
    for i, line in enumerate(lines[:5]):  # f"step {i}: total_loss={loss:.3f}"
        m = re.fullmatch(rf"step {i}: total_loss=(-?\d+\.\d{{3}})", line)
        assert m and math.isfinite(float(m.group(1))), line
    for b, line in enumerate(lines[5:]):  # f"image {b}: {n} detections, mask grid {shape} each"
        assert re.fullmatch(rf"image {b}: \d+ detections, mask grid \(28, 28\) each", line), line


def jax_rpn_counts(seed=7):
    """The counts ``examples/visualize_rpn_targets.py`` prints."""
    cfg = SHAPES_CONFIG
    batch = ShapesDataset(1, 128, 128, seed=seed).load_batch([0], cfg, with_masks=False)
    tgt = rpn_targets(jnp.asarray(config_anchors(cfg)), jnp.asarray(batch.gt_boxes[0]),
                      jnp.asarray(batch.gt_class_ids[0] > 0), cfg, jax.random.PRNGKey(0))
    target = np.asarray(tgt.target_class)
    return int((target == 1).sum()), int((target == -1).sum())


def test_rpn_target_example_counts_equal_jax(tmp_path):
    out = tmp_path / "rpn.png"
    proc = run_example("torch_visualize_rpn_targets.py", "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    n_pos, n_neg = jax_rpn_counts()
    assert n_pos < SHAPES_CONFIG.rpn_train_anchors_per_image // 2  # sampling does not bind
    assert proc.stdout.splitlines() == [f"wrote {out}: {n_pos} positive, {n_neg} negative anchors"]
    assert image_io.decode_image(out.read_bytes()).shape == (128, 128, 3)


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_visualize_rpn_targets"])
def test_examples_default_to_the_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        example.main([])
    assert not list(tmp_path.iterdir())  # nothing written
