"""The per-stage timing tool (``tools/torch_stage_time.py``) on the CPU.

At the 64² e2e_small budgets (``tests/test_golden_regression.py:34-46``,
16 detection rows, served in bf16 as ``bench`` serves; R50, batch 2, one
timed iteration), for
bf16 and int8 (per-channel, ``bench``'s default recipe): the tool checks its
full prefix against ``make_infer_fn`` and prints five lines in
``benchmarks/pipeline_breakdown.py``'s format, each prefix's delta over the
one before. Each prefix's outputs equal the stage outputs
``forward_inference`` returns as intermediates on the same state and batch,
and ``--stages`` times only the prefixes it names. Without a card the
tool's default device raises.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from objectdetection_torch import bench, detector
from objectdetection_torch import config as tconfig
from objectdetection_torch.convert import init_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("torch_stage_time",
                                              ROOT / "tools" / "torch_stage_time.py")
TOOL = importlib.util.module_from_spec(spec)
spec.loader.exec_module(TOOL)

# e2e_small's budgets at its size, with 16 detection rows as
# tests/test_torch_bench.py cuts them (the int8 mask head runs on every row,
# in exact f32 products on the CPU); compute_dtype stays bf16, which bench serves
E2E_SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
                 pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
                 train_rois_per_image=8, rpn_train_anchors_per_image=32, max_gt_objects=4,
                 detection_post_nms_instances=16)
ARGV = ["--backbone", "resnet50", "--image-size", "64", "--batch", "2", "--iters", "1",
        "--device", "cpu"]
LINE = re.compile(r"(\S+) +cum +(-?\d+\.\d\d) ms/batch  delta +(-?\d+\.\d\d) ms  "
                  r"\(first call \d+\.\ds\)")


@pytest.fixture
def e2e_small(monkeypatch):
    monkeypatch.setattr(tconfig, "COCO_CONFIG", tconfig.SHAPES_CONFIG.replace(**E2E_SMALL))


@pytest.mark.parametrize("extra, recipe, names", [
    (["--no-int8"], "bf16_b2", TOOL.NAMES),
    (["--per-channel", "--stages", "0,4"], "int8_pc_b2", ("extract", "+masks")),
], ids=["bf16", "int8"])
def test_prefixes_printed_after_the_full_prefix_check(e2e_small, capsys, extra, recipe, names):
    out = TOOL.main(ARGV + extra)
    captured = capsys.readouterr()
    assert "full prefix == make_infer_fn" in captured.err
    lines = captured.out.splitlines()
    assert out["config"] == recipe
    assert [m.group(1) for m in map(LINE.fullmatch, lines)] == list(names)
    assert [s["name"] for s in out["stages"]] == list(names)
    prev = 0.0
    for line, stage in zip(lines, out["stages"]):
        cum, delta = map(float, LINE.fullmatch(line).groups()[1:])
        assert cum == round(stage["cum_ms"], 2) and abs(delta - (cum - prev)) <= 0.011
        prev = cum


@pytest.mark.parametrize("per_channel, depths", [(False, range(5)), (True, (2, 4))],
                         ids=["bf16", "int8"])
def test_prefixes_are_the_pipelines_stages(e2e_small, per_channel, depths):
    # int8: the two prefixes whose ROIAlign reads the RPN's int8 P-levels
    args = TOOL.build_parser().parse_args(ARGV + (["--per-channel"] if per_channel
                                                  else ["--no-int8"]))
    cfg = bench.bench_config(TOOL.bench_args(args))
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
                              * 255.0 - 128.0)
    windows = torch.tensor([[0.0, 0.0, 64.0, 64.0]]).repeat(2, 1)
    state = bench.serving_state(init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                                images, cfg, "off", torch.device("cpu"))
    with torch.inference_mode():
        det, inter = detector.forward_inference(state, images, windows, cfg,
                                                return_intermediates=True)
        stages = {d: TOOL.run_prefix(state, cfg, images, windows, d) for d in depths}
    pyramid = list(inter["pyramid"].values())
    want = [pyramid + [inter["rpn_class_probs"], inter["rpn_bbox"]],
            pyramid + [inter["proposals"]],
            pyramid + [inter["mrcnn_class_probs"], inter["mrcnn_bbox"]],
            pyramid + [inter["detections"]],
            [inter["detections"], det.masks]]
    for depth, got in stages.items():
        ref = want[depth]
        assert len(got) == len(ref), depth
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), depth
    assert int(det.valid.sum()) > 0


def test_without_a_card_the_tool_raises(e2e_small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOL.main(ARGV[:-2])
