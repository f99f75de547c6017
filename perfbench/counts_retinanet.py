"""RetinaNet's counted work (:mod:`perfbench.counts`' rows and peaks): the
ResNet and its FPN without ``fpn_c2p2`` and ``fpn_p2``, with ``fpn_p6`` (3×3
stride 2 on C5) and ``fpn_p7`` (3×3 stride 2 on P6); on every level P3..P7
the class and box subnets' four 3×3 convs and their output convs, (C − 1)·A
and 4·A wide. The decode's sigmoid, top-k and NMS are not counted, as
:mod:`perfbench.counts` counts no elementwise work."""

from __future__ import annotations

from typing import List

from perfbench.counts import Op, conv_ops, pyramid_hw, resnet_fpn
from perfbench.reference.retinanet import anchors_per_location


def retinanet(sizes: dict, b: int, kinds: dict) -> List[Op]:
    """Every counted operation of a RetinaNet inference call at ``sizes`` for
    a batch of ``b``. ``kinds`` maps ``stem``, ``backbone``, ``subnet`` (the
    subnets' 3×3 convs) and ``output`` (the two output convs) to an
    arithmetic."""
    hw = tuple(sizes["image_shape"][:2])
    c = sizes["fpn_channels"]
    a = anchors_per_location(sizes)
    ops = [o for o in resnet_fpn(b, hw, sizes["backbone"], c, kinds["backbone"], kinds["stem"])
           if o.name not in ("fpn_c2p2", "fpn_p2")]
    levels = pyramid_hw(hw, sizes["backbone_strides"])
    ops += [Op("backbone", "fpn_p6", conv_ops(b, *levels[3], 2048, c, 3), kinds["backbone"]),
            Op("backbone", "fpn_p7", conv_ops(b, *levels[4], c, c, 3), kinds["backbone"])]
    for lh, lw in levels:
        for sub, out in (("class", (sizes["num_classes"] - 1) * a), ("box", 4 * a)):
            ops += [Op("subnets", f"{sub}_conv{i}", conv_ops(b, lh, lw, c if i == 0 else 256,
                                                             256, 3), kinds["subnet"])
                    for i in range(4)]
            ops.append(Op("subnets", f"{sub}_out", conv_ops(b, lh, lw, 256, out, 3),
                          kinds["output"]))
    return ops
