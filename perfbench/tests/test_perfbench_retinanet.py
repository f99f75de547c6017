"""The RetinaNet configuration (system ``configs/retinanet_r101_fpn_1024.py``,
reference ``reference/retinanet.py``, shaping ``sigmoid_shaping.py``, counts
``counts_retinanet.py``) and the rule that the benchmark's files run over a
program that lacks what RetinaNet added to it:

- the reference and its helpers load nothing of the program and run with
  TF32 off;
- the cell runs on the CPU at the tests' small size, traced, and reports its
  five metrics;
- the subnets' counted work against one conv worked by hand;
- the shaping gives every level of the pyramid detections, so that the
  comparison reads P4..P7 too: a program whose P6 is P5 subsampled (the
  JAX package's pyramid) is not correct;
- a program without spans (no ``metrics.collect``) still gives a line in
  both traced cells, without the five metrics; a program without the
  published RetinaNet stops the new cell in set-up with an error.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import counts, counts_retinanet, run, sigmoid_shaping, weights
from perfbench.reference import retinanet
from perfbench.tests.conftest import TINY_PARAMS, TINY_SIZES

CELL = "retinanet-bf16-b96"
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NEW = ["subnets_span_ms.infer", "subnets_roofline.infer", "retina_decode_span_ms.infer",
       "retina_nms_span_ms.infer", "retina_candidates_pct.infer"]
SIZES = run.load_json(run.HERE / "configs" / "retinanet_r101_fpn_1024_bf16.json")
SYSTEM = run.load_module(run.HERE / "configs" / "retinanet_r101_fpn_1024.py")


def traced(cell):
    return run.run_cell(cell, 2147483811, 0.0, True, "cpu", sizes_override=TINY_SIZES,
                        params_override=TINY_PARAMS)


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", (
        "import sys\n"
        "import perfbench.reference.retinanet, perfbench.sigmoid_shaping\n"
        "import perfbench.counts_retinanet\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('objectdetection_torch', 'objectdetection_tpu', 'jax', 'flax')))\n")],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_the_reference_runs_with_tf32_off(monkeypatch):
    seen = []

    def forward(p, images, sizes, prec):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     prec.mode))
        return torch.zeros(images.shape[0], 100, 6)

    system = SYSTEM.System.__new__(SYSTEM.System)
    system.weights, system.sizes = {}, SIZES
    monkeypatch.setattr(SYSTEM.retinanet, "forward", forward)
    before = torch.backends.cudnn.allow_tf32
    (det,) = system.reference(torch.zeros(2, 8, 8, 3), None, "fp8")
    assert seen == [(False, False, "fp8")] and det.shape == (2, 100, 6)
    assert torch.backends.cudnn.allow_tf32 == before


def test_the_cell_runs_traced_and_reports_its_metrics():
    line = traced(CELL)
    values = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(values), sorted(values)
    assert {"backbone_ms.infer", "heads_ms.infer", "backbone_roofline.infer", "infer_mfu",
            "device_idle_pct.infer"} <= set(values)
    for name in NEW[:4]:
        assert values[name] > 0, name
    assert 0 < values["retina_candidates_pct.infer"] <= 100
    assert line["correct"] is True, line["checks"]
    assert line["numbers"]["detections_per_image"] >= 1
    assert list(line)[-1] == "checks"


def test_the_new_metrics_list_the_new_cell_alone():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        assert declared[name]["workloads"] == [CELL]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if CELL in m.get("workloads", ()):
            assert m["workloads"][-1] == CELL


def test_subnet_counts_by_hand():
    ops = counts_retinanet.retinanet(SIZES, 2, SYSTEM.KINDS["bf16"])
    subnets = [o for o in ops if o.layer == "subnets"]
    assert len(subnets) == 5 * 2 * 5  # levels × subnets × (4 convs + the output)
    assert len(ops) - len(subnets) == len(counts.resnet_fpn(2, (1024, 1024), "resnet101", 256,
                                                            "bf16", "bf16"))  # −c2p2 −p2 +p6 +p7
    # the class output on P3: 128 × 128 positions, 256 → 720 channels, 3 × 3 taps,
    # one multiply-add two operations, in TF32
    p3 = [o for o in ops if o.name == "class_out"][0]
    assert p3.ops == 2 * 2 * 128 * 128 * 256 * 720 * 9 and p3.kind == "tf32"
    box = sum(o.ops for o in ops if o.name == "box_out")
    assert box == 2 * 2 * (128 ** 2 + 64 ** 2 + 32 ** 2 + 16 ** 2 + 8 ** 2) * 256 * 36 * 9
    assert {o.kind for o in subnets} == {"bf16", "tf32"}
    names = {o.name for o in ops}
    assert {"fpn_p6", "fpn_p7"} <= names and not {"fpn_c2p2", "fpn_p2"} & names
    p6 = [o for o in ops if o.name == "fpn_p6"][0]
    assert p6.ops == 2 * 2 * 16 * 16 * 2048 * 256 * 9
    # 34.74 ms of subnet work at peak a batch of 96 (PERF.md, PR 22)
    ms = counts.seconds_at_peak(counts_retinanet.retinanet(SIZES, 96, SYSTEM.KINDS["bf16"]),
                                ["subnets"]) * 1e3
    assert ms == pytest.approx(34.736, abs=1e-3)


@pytest.mark.parametrize("seed", [3, 2147483811])
def test_the_shaping_gives_every_level_detections(seed):
    sizes = {**SIZES, **TINY_SIZES}
    p = weights.make(retinanet.spec(sizes), seed, torch.device("cpu"), {})
    image = torch.from_numpy(np.random.RandomState(seed % 2**32).uniform(
        -128.0, 127.0, (1, 64, 64, 3)).astype(np.float32))
    shaped, got = sigmoid_shaping.retinanet_outputs(p, image, sizes, sizes["seeded_weights"])
    assert got["level_scale"][0] == 1.0 and len(got["level_scale"]) == 5
    assert min(got["level_detections"]) >= 5, got
    assert sum(got["level_detections"]) == got["detections"] == 100
    assert got["p3_over_gate"] >= 1000 and 5 <= got["over_half"] <= 20
    # each level's features scaled by its α, P7's conv by α7 / α6
    a = got["level_scale"]
    for name, s in zip(sigmoid_shaping.LEVEL_CONVS, a[:4] + [a[4] / a[3]]):
        ratio = shaped[name + ".weight"] / p[name + ".weight"]
        assert torch.allclose(ratio, torch.full_like(ratio, s), rtol=1e-4), name
    # box deltas at the rule's std, coordinate by coordinate
    with torch.inference_mode():
        _, deltas = sigmoid_shaping._outputs(shaped, image, sizes)
    std = torch.cat(deltas, 1)[0].std(0)
    assert torch.allclose(std, torch.tensor(sizes["seeded_weights"]["delta_std"]), rtol=1e-3)


def test_a_p6_taken_from_p5_reads_not_correct(monkeypatch):
    from objectdetection_torch.models import backbone

    forward = backbone.ResNetFPN.forward

    def p6_from_p5(self, x):
        out = forward(self, x)
        p6 = out[2][:, :, ::2, ::2]
        return out[:3] + (p6, self.fpn_p7(F.relu(p6)))

    monkeypatch.setattr(backbone.ResNetFPN, "forward", p6_from_p5)
    line = run.run_cell(CELL, 3300000101, 0.0, False, "cpu", sizes_override=TINY_SIZES,
                        params_override=TINY_PARAMS)
    assert line["correct"] is False, line["numbers"]


@pytest.mark.parametrize("cell", ["maskrcnn-bf16-b96", CELL])
def test_a_program_without_spans_still_gives_a_line(cell, monkeypatch):
    from objectdetection_torch import metrics

    monkeypatch.delattr(metrics, "collect")
    line = traced(cell)
    assert not set(NEW) & set(line["metrics"])
    assert "device_idle_pct.infer" in line["metrics"] and "infer_mfu" in line["metrics"]
    assert list(line)[-1] == "checks" and isinstance(line["correct"], bool)


def test_a_program_without_the_published_retinanet_stops_in_set_up(monkeypatch):
    from objectdetection_torch import config

    monkeypatch.delattr(config, "RetinaNetConfig")
    with pytest.raises(ImportError, match="RetinaNetConfig"):
        run.run_cell(CELL, 5, 0.0, False, "cpu", sizes_override=TINY_SIZES,
                     params_override=TINY_PARAMS)
