"""Hybrid Task Cascade's counted work (:mod:`perfbench.counts`' rows and
peaks): the ResNet-FPN and the RPN head as Mask R-CNN's; the semantic
branch at the fusion level's size (a 1×1 lateral a pyramid level, the 3×3
convs, the 1×1 embedding; its logits are not run); each box stage's two
fully connected layers and its class and box outputs over every ROI; each
mask head's ``conv_res`` (heads after the first), four 3×3 convs, 2×2
transposed conv and the detected class's 1×1 output over every detection
row. ROIAlign, the average pool, the resize, NMS and the elementwise work
are not counted, as :mod:`perfbench.counts` counts none."""

from __future__ import annotations

from typing import List

from perfbench.counts import Op, conv_ops, pyramid_hw, resnet_fpn

MASK_CHANNELS = 256


def htc(sizes: dict, b: int, kinds: dict) -> List[Op]:
    """Every counted operation of an HTC inference call at ``sizes`` for a
    batch of ``b``. ``kinds`` maps ``stem``, ``backbone``, ``rpn``,
    ``semantic``, ``head`` (the box stages' layers and the mask trunks),
    ``deconv`` and ``float`` (class, box and mask outputs) to an
    arithmetic. Layers: ``backbone``, ``rpn``, ``semantic``, ``box_heads``,
    ``mask_heads``."""
    hw = tuple(sizes["image_shape"][:2])
    c = sizes["fpn_channels"]
    k = len(sizes["rpn_anchor_ratios"])
    nc = sizes["num_classes"]
    levels = pyramid_hw(hw, sizes["backbone_strides"])
    ops = resnet_fpn(b, hw, sizes["backbone"], c, kinds["backbone"], kinds["stem"])
    for lh, lw in levels:
        ops += [Op("rpn", "rpn_conv_shared", conv_ops(b, lh, lw, c, 512, 3), kinds["rpn"]),
                Op("rpn", "rpn_heads", conv_ops(b, lh, lw, 512, 6 * k, 1), kinds["rpn"])]
    fh, fw = levels[sizes["semantic_fusion_level"]]
    sc = sizes["semantic_channels"]
    ops += [Op("semantic", f"lateral{i}", conv_ops(b, fh, fw, c, c, 1), kinds["semantic"])
            for i in range(len(levels))]
    ops += [Op("semantic", f"conv{i}", conv_ops(b, fh, fw, c if i == 0 else sc, sc, 3),
               kinds["semantic"]) for i in range(sizes["semantic_convs"])]
    ops.append(Op("semantic", "embedding", conv_ops(b, fh, fw, sc, sc, 1), kinds["semantic"]))
    r = b * sizes["post_nms_rois_inference"]
    ph, pw = sizes["pool_shape"]
    fc = sizes["fc_channels"]
    n = b * sizes["detection_post_nms_instances"]
    mh, mw = sizes["mask_pool_shape"]
    m = MASK_CHANNELS
    for t in range(len(sizes["stage_stds"])):
        ops += [Op("box_heads", f"fc1_{t}", 2.0 * r * ph * pw * c * fc, kinds["head"]),
                Op("box_heads", f"fc2_{t}", 2.0 * r * fc * fc, kinds["head"]),
                Op("box_heads", f"outputs_{t}", 2.0 * r * fc * (nc + 4), kinds["float"])]
        if t > 0:
            ops.append(Op("mask_heads", f"conv_res_{t}", conv_ops(n, mh, mw, m, m, 1),
                          kinds["head"]))
        ops += [Op("mask_heads", f"conv{i}_{t}", conv_ops(n, mh, mw, c if i == 0 else m, m, 3),
                   kinds["head"]) for i in range(4)]
        ops += [Op("mask_heads", f"deconv_{t}", conv_ops(n, mh, mw, m, m, 2), kinds["deconv"]),
                Op("mask_heads", f"mask_logits_{t}", 2.0 * n * 4 * mh * mw * m, kinds["float"])]
    return ops
