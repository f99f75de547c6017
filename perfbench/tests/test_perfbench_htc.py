"""The Hybrid Task Cascade configuration (system ``configs/htc_r101_fpn_1024.py``,
reference ``reference/htc.py``, shaping ``htc_shaping.py``, counts
``counts_htc.py``) and the rule that the benchmark's files run over a
program that lacks what HTC added to it:

- the reference and its helpers load nothing of the program and run with
  TF32 off;
- the cell runs on the CPU at the tests' small size (with fewer ROIs and
  rows, which the CPU holds), traced, and reports its six metrics and the
  shared ones; the new metrics list the new cell alone, and it sits before
  ``retinanet-bf16-b96`` in the lists they share;
- the counted work against the shapes worked by hand;
- the shaping gives detections over 0.5 on every seed tried;
- the comparison sees each mechanism: the reference cut to one box stage,
  without the semantic fusion or without the mask information flow reads
  not correct at the cell's limits against the whole reference;
- a program without spans still gives a line, without the six metrics; a
  program without ``HTCConfig`` stops the cell in set-up with an error.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import counts, counts_htc, htc_shaping, run, weights
from perfbench.configs.common import exact_f32
from perfbench.reference import htc
from perfbench.reference.compare import compare
from perfbench.tests.conftest import TINY_PARAMS, TINY_SIZES

CELL = "htc-bf16-b96"
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NEW = ["htc_semantic_span_ms.infer", "htc_box_stages_span_ms.infer",
       "htc_detection_span_ms.infer", "htc_mask_stages_span_ms.infer", "htc_mask_roofline.infer",
       "htc_nms_candidates_pct.infer"]
SHARED = ["backbone_ms.infer", "heads_ms.infer", "backbone_roofline.infer", "infer_mfu",
          "device_idle_pct.infer"]
SIZES = run.load_json(run.HERE / "configs" / "htc_r101_fpn_1024_bf16.json")
SYSTEM = run.load_module(run.HERE / "configs" / "htc_r101_fpn_1024.py")
# the tests' small size, with the ROI and row counts the CPU holds
SMALL = {**TINY_SIZES, "post_nms_rois_inference": 200, "detection_post_nms_instances": 20}


def traced(cell=CELL):
    return run.run_cell(cell, 2147483811, 0.0, True, "cpu", sizes_override=SMALL,
                        params_override=TINY_PARAMS)


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", (
        "import sys\n"
        "import perfbench.reference.htc, perfbench.htc_shaping, perfbench.counts_htc\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('objectdetection_torch', 'objectdetection_tpu', 'jax', 'flax')))\n")],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_the_reference_runs_with_tf32_off(monkeypatch):
    seen = []

    def forward(p, images, windows, sizes, prec, at=None):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     prec.mode, at is None))
        return torch.zeros(images.shape[0], 100, 6), torch.zeros(images.shape[0], 100, 28, 28)

    system = SYSTEM.System.__new__(SYSTEM.System)
    system.weights, system.sizes = {}, SIZES
    monkeypatch.setattr(SYSTEM.htc, "forward", forward)
    before = torch.backends.cudnn.allow_tf32
    det, masks = system.reference(torch.zeros(2, 8, 8, 3), None, "fp8")
    assert seen == [(False, False, "fp8", True)] and det.shape == (2, 100, 6)
    assert masks.shape == (2, 100, 28, 28)
    assert torch.backends.cudnn.allow_tf32 == before


def test_the_cell_runs_traced_and_reports_its_metrics():
    line = traced()
    values = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) | set(SHARED) <= set(values), sorted(values)
    for name in NEW[:5]:
        assert values[name] > 0, name
    assert 0 < values["htc_nms_candidates_pct.infer"] <= 100
    assert line["numbers"]["detections_per_image"] == 20
    assert line["numbers"]["program_detections_per_image"] == 20
    assert list(line)[-1] == "checks" and isinstance(line["correct"], bool)


def test_the_new_metrics_list_the_new_cell_alone():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        assert declared[name]["workloads"] == [CELL]
    shared = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
              if CELL in m.get("workloads", ()) and m["name"] not in NEW]
    assert sorted(m["name"] for m in shared) == sorted(SHARED + ["images_per_s"])
    for m in shared:
        cells = m["workloads"]
        assert cells.index(CELL) < cells.index("retinanet-bf16-b96")
    assert CELL in {w["name"] for w in BENCH["workloads"]}
    assert "perfbench/configs/htc_r101_fpn_1024_bf16.json" in {c["file"] for c in BENCH["configs"]}


def test_counts_by_hand():
    ops = counts_htc.htc(SIZES, 2, SYSTEM.KINDS["bf16"])
    layers = {}
    for o in ops:
        layers.setdefault(o.layer, []).append(o)
    assert sorted(layers) == ["backbone", "box_heads", "mask_heads", "rpn", "semantic"]
    assert len(layers["backbone"]) == len(counts.resnet_fpn(2, (1024, 1024), "resnet101", 256,
                                                            "bf16", "bf16"))
    # semantic: five 1×1 laterals and the 1×1 embedding at P3's 128², four 3×3 convs
    sem = sum(o.ops for o in layers["semantic"])
    assert sem == 2 * 2 * 128 * 128 * 256 * 256 * (5 + 4 * 9 + 1)
    # a box stage: 1000 ROIs an image, 12,544 → 1024 → 1024, then 81 + 4 outputs in f32
    box = [o for o in layers["box_heads"] if o.name.endswith("_0")]
    assert [o.ops for o in box] == [2 * 2000 * 12544 * 1024, 2 * 2000 * 1024 * 1024,
                                    2 * 2000 * 1024 * 85]
    assert [o.kind for o in box] == ["bf16", "bf16", "f32"]
    # the mask heads: 100 rows an image; a trunk conv 14² × 256 × 256 × 9, the
    # deconv 14² × 256 × 256 × 4, conv_res 14² × 256 × 256 (heads 2 and 3), the
    # detected class's output 28² × 256 in f32
    n = 200
    conv3, deconv, res, logits = (2 * n * 196 * 256 * 256 * 9, 2 * n * 196 * 256 * 256 * 4,
                                  2 * n * 196 * 256 * 256, 2 * n * 784 * 256)
    assert sum(o.ops for o in layers["mask_heads"]) == 3 * (4 * conv3 + deconv + logits) + 2 * res
    assert {o.kind for o in layers["mask_heads"] if "logits" in o.name} == {"f32"}
    # ~1.05 GFLOP a row and head: 30.1 TFLOP of mask heads a batch of 96
    total = sum(o.ops for o in counts_htc.htc(SIZES, 96, SYSTEM.KINDS["bf16"])
                if o.layer == "mask_heads")
    assert total == pytest.approx(30.10e12, rel=1e-3)


@pytest.mark.parametrize("seed", [3, 2147483811])
def test_the_shaping_gives_detections(seed):
    sizes = {**SIZES, **SMALL}
    p = weights.make(htc.spec(sizes), seed, torch.device("cpu"), sizes["seeded_weights"])
    image = torch.from_numpy(np.random.RandomState(seed % 2**32).uniform(
        -128.0, 127.0, (1, 64, 64, 3)).astype(np.float32))
    shaped, got = htc_shaping.htc_outputs(p, image, sizes, sizes["seeded_weights"])
    assert 5 <= got["over_half"] <= 20 and got["top_score"] > 0.9
    assert len(got["delta_scales"]) == 3 and len(got["mask_scales"]) == 3
    assert len(got["flow_scales"]) == 2
    others = torch.from_numpy(np.random.RandomState(seed % 2**32 + 1).uniform(
        -128.0, 127.0, (2, 64, 64, 3)).astype(np.float32))
    windows = torch.tensor([[0.0, 0.0, 64.0, 64.0]]).repeat(2, 1)
    with exact_f32():
        det, _ = htc.forward(shaped, others, windows, sizes)
    over = (det[..., 5] > 0.5).sum(-1)
    assert bool((over >= 1).all()), over  # images apart from the shaping one detect too
    assert bool((det[..., 5] > sizes["score_threshold"]).all())  # every row filled


@pytest.mark.parametrize("cut", [dict(stages=1), dict(fusion=False), dict(flow=False)],
                         ids=["one_box_stage", "no_semantic_fusion", "no_mask_flow"])
def test_a_cut_network_reads_not_correct(cut):
    sizes = {**SIZES, **SMALL}
    cell = run.load_json(run.HERE / "workloads" / f"{CELL}.json")
    p = weights.make(htc.spec(sizes), 5, torch.device("cpu"), sizes["seeded_weights"])
    image = torch.from_numpy(np.random.RandomState(5).uniform(
        -128.0, 127.0, (3, 64, 64, 3)).astype(np.float32))
    p, _ = htc_shaping.htc_outputs(p, image[:1], sizes, sizes["seeded_weights"])
    windows = torch.tensor([[0.0, 0.0, 64.0, 64.0]]).repeat(2, 1)
    with exact_f32():
        det, masks = htc.forward(p, image[1:], windows, sizes, **cut)
        want_det, _, want_at = htc.forward(p, image[1:], windows, sizes, at=det)
    numbers = compare(det.numpy(), want_det.numpy(), sizes["score_threshold"], masks.numpy(),
                      want_at.numpy())
    checks = run.checks_of(numbers, cell["checks"])
    assert not all(run.passed(c) for c in checks.values()), numbers


def test_a_program_without_spans_still_gives_a_line(monkeypatch):
    from objectdetection_torch import metrics

    monkeypatch.delattr(metrics, "collect")
    line = traced()
    assert not set(NEW) & set(line["metrics"])
    assert "device_idle_pct.infer" in line["metrics"] and "infer_mfu" in line["metrics"]
    assert list(line)[-1] == "checks" and isinstance(line["correct"], bool)


def test_a_program_without_htc_stops_in_set_up(monkeypatch):
    from objectdetection_torch import config

    monkeypatch.delattr(config, "HTCConfig")
    with pytest.raises(ImportError, match="HTCConfig"):
        run.run_cell(CELL, 5, 0.0, False, "cpu", sizes_override=SMALL,
                     params_override=TINY_PARAMS)
