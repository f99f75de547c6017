"""Greedy non-max suppression: plain PyTorch version and the CUDA kernel.

Port of ``objectdetection_tpu.ops.nms`` (``non_max_suppression``,
``_finalize``, ``nms_boxes``) and of the Pallas kernel
``objectdetection_tpu/ops/nms_pallas.py`` ``_nms_kernel``, whose CUDA
counterpart is ``csrc/nms.cu``. Inputs carry an explicit batch dimension.

:func:`suppress` is the kernel's contract: score-sorted boxes [B, N, 4] and
class ids [B, N] in, the same box table out with dead rows zeroed. It launches
the two kernels of ``csrc/nms.cu`` (the pairwise kill bits, then the greedy
sweep) for a CUDA tensor and runs :func:`suppress_plain` for a CPU tensor.
Rows are resolved in tiles of :data:`TILE` rows, and the pass stops after the
tile in which the count of nonzero survivors reaches ``budget`` (rows after it
read as suppressed), which is what ``nms_suppress_pallas`` returns at its
default tile.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from objectdetection_torch.ops import cuda_build

TILE = 256
CHUNK = 64  # rows per 64-bit word of the kernels' pairwise kill bits
# the kill bits take N * ceil(N / 64) words of scratch per image and the sweep
# holds one row of words in shared memory: 16,384 rows (256 words, 32 MB of
# scratch per image) is the most the kernels take
MAX_ROWS = 16_384

# one entry a `suppress` call, though it launches two kernels; tallied as "nms"
_SUPPRESS = cuda_build.Entry("nms", "nms_suppress", [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int], name="nms")


class NMSResult(NamedTuple):
    indices: torch.Tensor  # [B, max_output] int64, -1 padded, score order
    valid: torch.Tensor  # [B, max_output] bool


def _iou_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, 4] × b [K, 4] → IoU [M, K]; operation order of nms_pallas._iou_rows."""
    ay1, ax1, ay2, ax2 = a[:, 0:1], a[:, 1:2], a[:, 2:3], a[:, 3:4]
    by1, bx1, by2, bx2 = b[None, :, 0], b[None, :, 1], b[None, :, 2], b[None, :, 3]
    inter_y = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter_x = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    inter = inter_y * inter_x
    area_a = (ay2 - ay1) * (ax2 - ax1)
    area_b = (by2 - by1) * (bx2 - bx1)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _suppress_one(boxes, cls, thr, budget):
    n = boxes.shape[0]
    out = torch.zeros_like(boxes)
    sup_boxes = boxes[:0]
    sup_cls = cls[:0]
    count = 0
    for start in range(0, n, TILE):
        if count >= budget:
            break
        tile = boxes[start:start + TILE]
        tcls = cls[start:start + TILE]
        t = tile.shape[0]
        cross_ok = ~(
            (_iou_rows(tile, sup_boxes) > thr) & (tcls[:, None] == sup_cls[None, :])
        ).any(dim=1)
        r = torch.arange(t, device=boxes.device)
        # sup[i, j]: earlier row j kills row i
        sup = (
            (_iou_rows(tile, tile) > thr)
            & (tcls[:, None] == tcls[None, :])
            & (r[None, :] < r[:, None])
        )
        # greedy recurrence to its fixpoint (row i is final after i rounds)
        alive = cross_ok
        for _ in range(t):
            nxt = cross_ok & ~(sup & alive[None, :]).any(dim=1)
            if torch.equal(nxt, alive):
                break
            alive = nxt
        out[start:start + t] = torch.where(alive[:, None], tile, torch.zeros_like(tile))
        live = alive & (tile != 0).any(dim=1)
        sup_boxes = torch.cat([sup_boxes, tile[live]])
        sup_cls = torch.cat([sup_cls, tcls[live]])
        count = sup_boxes.shape[0]
    return out


def suppress_plain(
    sorted_boxes: torch.Tensor, class_ids: torch.Tensor, iou_threshold: float,
    budget: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`suppress` (same arguments, same result)."""
    b, n, _ = sorted_boxes.shape
    budget = n if budget is None else min(int(budget), n)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=sorted_boxes.device)
    boxes = sorted_boxes.to(torch.float32)
    cls = class_ids.to(torch.int32)
    return torch.stack([_suppress_one(boxes[i], cls[i], thr, budget) for i in range(b)])


def suppress(
    sorted_boxes: torch.Tensor, class_ids: torch.Tensor, iou_threshold: float,
    budget: Optional[int] = None,
) -> torch.Tensor:
    """Greedy suppression over score-sorted boxes.

    sorted_boxes [B, N, 4] f32 (descending score, invalid rows zeroed,
    corners canonicalized), class_ids [B, N] int32. Returns [B, N, 4] with
    suppressed rows zeroed. ``budget``: stop once that many nonzero survivors
    exist (at tile granularity); None keeps every survivor. On the card N is
    at most :data:`MAX_ROWS` (the kernels' N² / 8 bytes of scratch per image);
    above it this raises ``ValueError``.
    """
    if not cuda_build.takes_kernel(sorted_boxes, "nms"):
        return suppress_plain(sorted_boxes, class_ids, iou_threshold, budget)
    b, n, four = sorted_boxes.shape
    if four != 4 or class_ids.shape != (b, n):
        raise ValueError(f"nms: bad shapes {sorted_boxes.shape}, {class_ids.shape}")
    if n > MAX_ROWS:
        raise ValueError(f"nms kernel: {n} rows > {MAX_ROWS}")
    budget = n if budget is None else min(int(budget), n)
    boxes = sorted_boxes.to(torch.float32).contiguous()
    cls = class_ids.to(device=boxes.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(boxes)
    if b == 0 or n == 0:
        return out
    # only the upper triangle of 64-row chunks is written and read
    kill_bits = torch.empty((b, n, -(-n // CHUNK)), dtype=torch.int64, device=boxes.device)
    _SUPPRESS.launch(boxes.device, boxes.data_ptr(), cls.data_ptr(), out.data_ptr(),
                     kill_bits.data_ptr(), b, n, float(iou_threshold), budget)
    return out


def non_max_suppression(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output: int,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    class_ids: Optional[torch.Tensor] = None,
    assume_sorted: bool = False,
) -> NMSResult:
    """Batched greedy NMS: boxes [B, N, 4], scores [B, N].

    ``valid`` [B, N] bool: boxes to consider at all. ``class_ids`` [B, N]:
    suppress only equal ids (per-class NMS in one pass). ``assume_sorted``:
    inputs are already in descending-score order. Returns the first
    ``max_output`` survivors' indices in score order, -1 padded.
    """
    b, n, _ = boxes.shape
    dev = boxes.device
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    if class_ids is None:
        class_ids = torch.zeros((b, n), dtype=torch.int32, device=dev)
    scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))

    if assume_sorted:
        order = torch.arange(n, device=dev).expand(b, n)
        sboxes, svalid, sclass = boxes.to(torch.float32), valid, class_ids
    else:
        order = torch.sort(-scores, dim=1, stable=True).indices
        sboxes = torch.gather(boxes, 1, order[..., None].expand(b, n, 4)).to(torch.float32)
        svalid = torch.gather(valid, 1, order)
        sclass = torch.gather(class_ids, 1, order)

    # canonicalize corners (min, max), then zero invalid rows: zero rows have
    # IoU 0 with everything, so they neither suppress nor survive
    sboxes = torch.cat(
        [torch.minimum(sboxes[..., 0:2], sboxes[..., 2:4]),
         torch.maximum(sboxes[..., 0:2], sboxes[..., 2:4])], dim=-1,
    )
    sboxes = torch.where(svalid[..., None], sboxes, torch.zeros_like(sboxes))
    out_boxes = suppress(sboxes, sclass, iou_threshold, budget=max_output)
    return _finalize(out_boxes, svalid, order, max_output)


def _finalize(out_boxes, svalid, order, max_output) -> NMSResult:
    """Survivor table → compact (indices, valid) in descending-score order."""
    b, n, _ = out_boxes.shape
    kept = svalid & (out_boxes != 0).any(dim=-1)
    k = min(max_output, n)
    # kept row i ↦ key n - i, dead rows ↦ 0: the top k keys are the earliest
    # kept rows in order
    keys = torch.where(kept, torch.arange(n, 0, -1, device=out_boxes.device), 0)
    top_keys, top_rows = torch.topk(keys, k, dim=1)
    out_valid = top_keys > 0
    orig_idx = torch.gather(order, 1, top_rows)
    out_idx = torch.where(out_valid, orig_idx, -1)
    if k < max_output:
        pad = max_output - k
        out_idx = torch.cat([out_idx, out_idx.new_full((b, pad), -1)], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((b, pad))], dim=1)
    return NMSResult(indices=out_idx, valid=out_valid)


def nms_boxes(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output: int,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    assume_sorted: bool = False,
) -> torch.Tensor:
    """NMS returning the kept boxes zero-padded to [B, max_output, 4]."""
    res = non_max_suppression(
        boxes, scores, max_output, iou_threshold, valid=valid,
        assume_sorted=assume_sorted,
    )
    idx = res.indices.clamp(min=0)
    gathered = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
    return torch.where(res.valid[..., None], gathered, torch.zeros_like(gathered))
