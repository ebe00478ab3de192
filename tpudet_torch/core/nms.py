"""Shape-static NMS, batched over images: port of ``tpudet/core/nms.py``
(``topk_scores``, ``nms_blocked``, ``nms_padded``, ``soft_nms_padded``,
``nms``, ``multiclass_nms``/``batched_nms``, ``dense_class_nms``,
``class_sorted_nms``, ``lane_topk_select``, ``class_lane_nms`` and their
batched forms). YOLACT's ``fast_nms`` and the oracle ``nms_padded_scan``
wait (ROADMAP.md).

Semantics kept from tpudet, so that the detection sets are equal:

- score ties keep index order: every sort is ``torch.sort(stable=True)``
  (``torch.topk`` leaves the order of ties unspecified), and soft-NMS
  picks the first maximum, as ``jnp.argmax``;
- suppression is strict ``iou > thr``, with tpudet's IoU arithmetic;
- ``lane_topk_select`` breaks ties at the first occurrence and pulls the
  box payload with an exact select-and-sum;
- class-aware NMS offsets each class's boxes by ``label * (max coord +
  1)`` so that one class-agnostic pass never lets classes overlap;
- outputs are fixed-size, ``max_out`` rows plus a ``valid`` mask.

One deliberate difference: above 16,384 candidates tpudet's
``topk_scores`` takes ``approx_max_k`` on the TPU; the port always takes
the exact top-k (on the CPU tpudet returns the same).

The functions take a leading batch axis; the single-image names
(``multiclass_nms``, ``dense_class_nms``, ``class_sorted_nms``,
``class_lane_nms``) run a batch of one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e10


class NMSResult(NamedTuple):
    """Fixed-size detections, (B, max_per_img, ...)."""
    bboxes: torch.Tensor  # (B, max_per_img, 4)
    scores: torch.Tensor  # (B, max_per_img)
    labels: torch.Tensor  # (B, max_per_img) int64, -1 where not valid
    valid: torch.Tensor  # (B, max_per_img) bool


def topk_scores(scores: torch.Tensor, k: int):
    """(vals, idx) of the exact top-k along the last axis, ties broken by
    the lowest index (``lax.top_k``'s order). tpudet takes ``approx_max_k``
    above 16,384 candidates; on the CPU that returns exactly this."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _iou_block(bb, ba, other_boxes, other_area, eps=1e-6):
    """IoU of (..., B, 4) boxes against (..., M, 4) boxes -> (..., B, M)."""
    lt = torch.maximum(bb[..., :, None, :2], other_boxes[..., None, :, :2])
    rb = torch.minimum(bb[..., :, None, 2:], other_boxes[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp_min(
        ba[..., :, None] + other_area[..., None, :] - inter, eps)


def _while(cond, body, state):
    """Run ``state = body(*state)`` while ``cond(*state)`` holds, with the
    same ``cond`` and ``body`` run two ways. Eager code reads each
    ``cond`` on the host (one sync an iteration, no compile). Under
    ``torch.export`` the loop is a ``while_loop`` node of the graph: the
    trace reads no value and the program stays shape-static (an exported
    program's ``while_loop`` reads its ``cond`` on the host as it runs,
    as the eager loop does)."""
    if torch.compiler.is_exporting():
        from torch._higher_order_ops import while_loop
        # while_loop refuses a cond output that aliases an input
        return tuple(while_loop(lambda *s: cond(*s).clone(), body,
                                tuple(state)))
    while bool(cond(*state)):
        state = body(*state)
    return state


def _in_block_greedy(bb, ba, alive0, tri, iou_threshold):
    """Greedy suppression inside a score-sorted block, as the Jacobi
    fixed point of ``keep = alive0 & ~any(suppressor kept)``; the fixed
    point is the greedy solution (tpudet's ``in_block_greedy``, ``cond``
    the flag that the last step changed ``keep``)."""
    mat = (_iou_block(bb, ba, bb, ba) > iou_threshold) & tri

    def step(keep, _changed):
        new = alive0 & ~torch.any(mat & keep[:, None, :], dim=-1)
        return new, torch.any(new != keep)

    return _while(lambda _keep, changed: changed, step,
                  step(alive0, None))[0]


def nms_blocked(boxes: torch.Tensor,
                scores: torch.Tensor,
                iou_threshold: float,
                max_out: int,
                valid: Optional[torch.Tensor] = None,
                block: int = 512,
                return_dets: bool = False):
    """Greedy hard-NMS in score-sorted blocks of ``block`` candidates,
    exact. Per block: suppress by the boxes kept so far, resolve the
    block's own chains, append its keeps; stop once every image holds
    ``max_out`` keeps or only padding remains. The walk and the in-block
    fixed point are tpudet's ``cond``/``body`` pairs (``tpudet/core/
    nms.py:184-246``) over tensors, each image's count and active flag
    carried as tensors (the block index too under export); :func:`_while`
    drives them, a Python loop in eager code and a ``while_loop`` under
    ``torch.export``.

    Args:
        boxes: (B, K, 4); scores: (B, K); valid: optional (B, K) bool.

    Returns:
        ``(keep_idx, keep_valid)``, each (B, max_out), indices into K; with
        ``return_dets`` also the kept boxes and scores first. Slots past
        the last keep are 0 and not valid.
    """
    b, k = scores.shape
    dev = scores.device
    vmask = (torch.ones_like(scores, dtype=torch.bool) if valid is None
             else valid)
    masked = torch.where(vmask, scores, torch.full_like(scores, NEG_INF))
    svals, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(b, k, 4))
    svalid = svals > NEG_INF / 2

    nb = -(-k // block)
    # one more block of padding, which the walk reads when it has passed
    # the last one
    pad = (nb + 1) * block - k
    blocks_boxes = F.pad(sboxes, (0, 0, 0, pad)).reshape(b, nb + 1, block, 4)
    blocks_valid = F.pad(svalid, (0, pad)).reshape(b, nb + 1, block)
    blocks_idx = F.pad(order, (0, pad)).reshape(b, nb + 1, block)
    blocks_scores = F.pad(svals, (0, pad)).reshape(b, nb + 1, block)

    rank = torch.arange(block, device=dev)
    tri = rank[None, :] < rank[:, None]  # suppressor j ranks before i
    out_slots = torch.arange(max_out, device=dev)

    # the eager walk indexes with a host int and writes the kept buffers in
    # place, as a Python loop over blocks would; the traced one carries the
    # block index as a tensor and returns new buffers (a while_loop body may
    # not write its inputs). The arithmetic is the same.
    exporting = torch.compiler.is_exporting()

    def at(blocks, bi):
        if exporting:
            return blocks.index_select(1, bi.reshape(1))[:, 0]
        return blocks[:, bi]

    def put(kept, wpos, src):
        if exporting:
            return kept.scatter(1, wpos, src)
        return kept.scatter_(1, wpos, src)

    def leads(bi, count):
        # sorted order: a block led by padding holds only padding
        return (count < max_out) & at(blocks_valid, bi)[:, 0]

    def cond(_bi, active, *_kept):
        return torch.any(active)

    def body(bi, active, count, kept_boxes, kept_area, kept_scores,
             kept_idx):
        bb = at(blocks_boxes, bi)
        ba = (bb[..., 2] - bb[..., 0]) * (bb[..., 3] - bb[..., 1])
        kvalid = out_slots[None, :] < count[:, None]
        iou_kept = _iou_block(bb, ba, kept_boxes[:, :max_out],
                              kept_area[:, :max_out])
        suppressed = torch.any((iou_kept > iou_threshold) & kvalid[:, None, :],
                               dim=-1)
        alive0 = at(blocks_valid, bi) & active[:, None] & ~suppressed
        keep = _in_block_greedy(bb, ba, alive0, tri, iou_threshold)

        pos = count[:, None] + torch.cumsum(keep, dim=-1) - 1
        wpos = torch.where(keep & (pos < max_out), pos,
                           torch.full_like(pos, max_out))
        count = count + keep.sum(dim=-1)
        return (bi + 1, leads(bi + 1, count), count,
                put(kept_boxes, wpos[..., None].expand(b, block, 4), bb),
                put(kept_area, wpos, ba),
                put(kept_scores, wpos, at(blocks_scores, bi)),
                put(kept_idx, wpos, at(blocks_idx, bi)))

    # one spare slot (index max_out) absorbs the writes that are dropped
    bi = torch.zeros((), dtype=torch.long, device=dev) if exporting else 0
    count = torch.zeros(b, dtype=torch.long, device=dev)
    state = (bi, leads(bi, count), count,
             boxes.new_zeros(b, max_out + 1, 4),
             boxes.new_zeros(b, max_out + 1),
             scores.new_zeros(b, max_out + 1),
             torch.zeros(b, max_out + 1, dtype=torch.long, device=dev))
    _, _, count, kept_boxes, _, kept_scores, kept_idx = _while(cond, body,
                                                               state)

    keep_valid = out_slots[None, :] < torch.clamp_max(count, max_out)[:, None]
    keep_idx = torch.where(keep_valid, kept_idx[:, :max_out], 0)
    if return_dets:
        boxes_out = torch.where(keep_valid[..., None],
                                kept_boxes[:, :max_out], 0.)
        scores_out = torch.where(keep_valid, kept_scores[:, :max_out], 0.)
        return boxes_out, scores_out, keep_idx, keep_valid
    return keep_idx, keep_valid


def _gather_rows(x, idx):
    """``x[b, idx[b]]`` for (B, K, ...) ``x`` and (B, M) ``idx``."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def nms_padded(boxes: torch.Tensor,
               scores: torch.Tensor,
               iou_threshold: float,
               max_out: int,
               valid: Optional[torch.Tensor] = None):
    """Greedy hard-NMS over padded candidates, exact, under tpudet's name
    and contract: ``nms_blocked`` for every K (tpudet builds the K x K
    suppression matrix up to 1,536 candidates, a TPU cost choice).

    Args:
        boxes: (B, K, 4) (already class-offset for class-aware NMS);
            scores: (B, K); valid: optional (B, K) bool.

    Returns:
        ``(keep_idx, keep_valid)``, each (B, max_out), indices into K in
        score order; slots past the last keep are 0 and not valid.
    """
    return nms_blocked(boxes, scores, iou_threshold, max_out, valid)


def soft_nms_padded(boxes: torch.Tensor,
                    scores: torch.Tensor,
                    iou_threshold: float,
                    max_out: int,
                    valid: Optional[torch.Tensor] = None,
                    sigma: float = 0.5,
                    min_score: float = 1e-3,
                    method: str = 'linear'):
    """Soft-NMS: ``max_out`` sequential picks of the highest remaining
    score (the first on a tie); after each pick the others decay
    (``'linear'``: ``s *= 1 - iou`` where ``iou > thr``; ``'gaussian'``:
    ``s *= exp(-iou^2 / sigma)``) and the pick leaves the pool. A pick is
    valid while its score exceeds ``min_score``.

    Args:
        boxes: (B, K, 4); scores: (B, K); valid: optional (B, K) bool.

    Returns:
        ``(keep_idx, keep_scores, keep_valid)``, each (B, max_out); the
        scores are the decayed ones, as mmcv's.
    """
    if method not in ('linear', 'gaussian'):
        raise ValueError(method)
    b, _ = scores.shape
    cur = scores if valid is None else torch.where(
        valid, scores, torch.full_like(scores, NEG_INF))
    area = ((boxes[..., 2] - boxes[..., 0]) *
            (boxes[..., 3] - boxes[..., 1]))
    rows = torch.arange(b, device=scores.device)
    floor = max(min_score, NEG_INF / 2)
    idxs, tops = [], []
    for _ in range(max_out):
        idx = cur.argmax(dim=-1)  # the first maximum
        top = cur[rows, idx]
        iou = _iou_block(boxes[rows, idx][:, None], area[rows, idx][:, None],
                         boxes, area)[:, 0]
        if method == 'linear':
            decay = torch.where(iou > iou_threshold, 1.0 - iou,
                                torch.ones_like(iou))
        else:
            decay = torch.exp(-(iou * iou) / sigma)
        cur = (cur * decay).index_put_((rows, idx),
                                       cur.new_tensor(NEG_INF))
        idxs.append(idx)
        tops.append(top)
    keep_scores = torch.stack(tops, dim=1)
    return torch.stack(idxs, dim=1), keep_scores, keep_scores > floor


def nms(boxes, scores, iou_threshold, max_out, valid=None):
    """Class-agnostic NMS with gathered, padded detections: boxes (B, K, 4),
    scores (B, K) -> ``(det_boxes, det_scores, keep_idx, keep_valid)``."""
    keep_idx, keep_valid = nms_padded(boxes, scores, iou_threshold, max_out,
                                      valid)
    det_boxes = torch.where(keep_valid[..., None],
                            _gather_rows(boxes, keep_idx), 0.)
    det_scores = torch.where(keep_valid, torch.gather(scores, 1, keep_idx),
                             0.)
    return det_boxes, det_scores, keep_idx, keep_valid


def _class_offsets(boxes, valid, labels):
    """Each box's class offset ``label * (max coord + 1)``, the max over
    each image's valid boxes, and the step ``max coord + 1`` (B, 1)."""
    max_coord = torch.where(valid[..., None], boxes, 0.).amax(dim=(1, 2))
    step = (max_coord + 1.)[:, None]
    return labels.to(boxes.dtype) * step, step


def batched_nms(bboxes: torch.Tensor,
                scores: torch.Tensor,
                score_thr: float,
                iou_thr: float,
                max_per_img: int,
                nms_pre: int = 4096,
                valid: Optional[torch.Tensor] = None,
                nms_type: str = 'nms',
                sigma: float = 0.5,
                min_score: float = 1e-3,
                method: str = 'linear') -> NMSResult:
    """Class-aware NMS of the reference ``multiclass_nms``: every (box,
    class) pair above ``score_thr`` is a candidate, the top ``nms_pre`` by
    score (ties by index) go through one class-offset pass of greedy NMS,
    or of soft-NMS with ``nms_type='soft_nms'``.

    Args:
        bboxes: (B, N, 4) boxes shared across classes; scores: (B, N, C)
            without a background column; valid: optional (B, N) bool.
    """
    b, n, num_classes = scores.shape
    flat_scores = scores.reshape(b, n * num_classes)  # class fastest
    cand_valid = flat_scores > score_thr
    if valid is not None:
        cand_valid = cand_valid & valid.repeat_interleave(num_classes, dim=1)
    masked = torch.where(cand_valid, flat_scores,
                         torch.full_like(flat_scores, NEG_INF))
    top_scores, top_cand = topk_scores(masked, min(nms_pre, n * num_classes))
    top_valid = top_scores > NEG_INF / 2
    labels = top_cand % num_classes
    cand_boxes = _gather_rows(bboxes, top_cand // num_classes)
    offsets, _ = _class_offsets(cand_boxes, top_valid, labels)
    offset_boxes = cand_boxes + offsets[..., None]
    if nms_type == 'soft_nms':
        keep_idx, soft_scores, keep_valid = soft_nms_padded(
            offset_boxes, top_scores, iou_thr, max_per_img, top_valid,
            sigma=sigma, min_score=min_score, method=method)
        det_scores = torch.where(keep_valid, soft_scores, 0.)
    else:
        keep_idx, keep_valid = nms_padded(offset_boxes, top_scores, iou_thr,
                                          max_per_img, top_valid)
        det_scores = torch.where(keep_valid,
                                 torch.gather(top_scores, 1, keep_idx), 0.)
    det_bboxes = torch.where(keep_valid[..., None],
                             _gather_rows(cand_boxes, keep_idx), 0.)
    det_labels = torch.where(keep_valid, torch.gather(labels, 1, keep_idx),
                             -1)
    return NMSResult(det_bboxes, det_scores, det_labels, keep_valid)


def batched_dense_class_nms(bboxes: torch.Tensor,
                            scores: torch.Tensor,
                            score_thr: float,
                            iou_thr: float,
                            max_per_img: int,
                            valid: Optional[torch.Tensor] = None
                            ) -> NMSResult:
    """Exact uncapped class-aware NMS (the reference's ``nms_pre=-1``):
    each (image, class) column runs its own blocked greedy NMS (blocks of
    128) on the shared boxes, and the top ``max_per_img`` of all classes'
    keeps by score (ties by class, then rank) are returned. A class can
    give at most ``max_per_img`` detections, so its keep cap is exact.

    Args:
        bboxes: (B, N, 4); scores: (B, N, C); valid: optional (B, N).
    """
    b, n, num_classes = scores.shape
    st = scores.transpose(1, 2).reshape(b * num_classes, n)
    v = st > score_thr
    if valid is not None:
        v = v & valid.repeat_interleave(num_classes, dim=0)
    boxes = bboxes[:, None].expand(b, num_classes, n, 4).reshape(
        b * num_classes, n, 4)
    kb, ks, _, kv = nms_blocked(boxes, st, iou_thr, max_per_img, valid=v,
                                block=128, return_dets=True)
    flat_s = torch.where(kv, ks, torch.full_like(ks, NEG_INF)).reshape(
        b, num_classes * max_per_img)
    flat_b = kb.reshape(b, num_classes * max_per_img, 4)
    top_s, order = torch.sort(flat_s, dim=-1, descending=True, stable=True)
    top_s, order = top_s[:, :max_per_img], order[:, :max_per_img]
    det_valid = top_s > NEG_INF / 2
    return NMSResult(
        torch.where(det_valid[..., None], _gather_rows(flat_b, order), 0.),
        torch.where(det_valid, top_s, 0.),
        torch.where(det_valid, order // max_per_img, -1), det_valid)


def _offset_nms(flat_scores, flat_boxes, per_class, iou_thr, max_per_img
                ) -> NMSResult:
    """One blocked greedy pass over class-major candidates, ``per_class``
    slots per class (empty slots score NEG_INF), each class offset so
    that no two classes overlap; the offsets come off the kept boxes."""
    flat_valid = flat_scores > NEG_INF / 2
    labels = torch.arange(flat_scores.shape[1],
                          device=flat_scores.device) // per_class
    offs, step = _class_offsets(flat_boxes, flat_valid, labels[None, :])
    det_off_boxes, det_scores, keep_idx, keep_valid = nms_blocked(
        flat_boxes + offs[..., None], flat_scores, iou_thr, max_per_img,
        valid=flat_valid, return_dets=True)
    det_labels = torch.where(keep_valid, keep_idx // per_class, -1)
    det_boxes = det_off_boxes - torch.where(
        keep_valid, det_labels.to(det_off_boxes.dtype) * step, 0.)[..., None]
    return NMSResult(det_boxes, det_scores, det_labels, keep_valid)


def batched_class_sorted_nms(bboxes: torch.Tensor,
                             scores: torch.Tensor,
                             score_thr: float,
                             iou_thr: float,
                             max_per_img: int,
                             class_pre: int = 256,
                             valid: Optional[torch.Tensor] = None
                             ) -> NMSResult:
    """Class-aware NMS with a per-class candidate budget: the top
    ``class_pre`` of each class column by score (ties by index), then one
    blocked greedy walk over all classes at once.

    Args:
        bboxes: (B, N, 4); scores: (B, N, C); valid: optional (B, N).
    """
    b, n, num_classes = scores.shape
    p = min(class_pre, n)
    st = scores.transpose(1, 2)  # (B, C, N)
    v = st > score_thr
    if valid is not None:
        v = v & valid[:, None, :]
    svals, order = torch.sort(torch.where(v, st, torch.full_like(st, NEG_INF)),
                              dim=-1, descending=True, stable=True)
    cand_boxes = _gather_rows(bboxes, order[..., :p].reshape(
        b, num_classes * p))
    return _offset_nms(svals[..., :p].reshape(b, num_classes * p),
                       cand_boxes, p, iou_thr, max_per_img)


def _one_image(batched, bboxes, scores, valid, *args, **kwargs):
    res = batched(bboxes[None], scores[None], *args,
                  valid=None if valid is None else valid[None], **kwargs)
    return NMSResult(*(t[0] for t in res))


def multiclass_nms(bboxes, scores, score_thr, iou_thr, max_per_img,
                   nms_pre=4096, valid=None, nms_type='nms', sigma=0.5,
                   min_score=1e-3, method='linear') -> NMSResult:
    """`batched_nms` for one image: bboxes (N, 4), scores (N, C)."""
    return _one_image(batched_nms, bboxes, scores, valid, score_thr,
                      iou_thr, max_per_img, nms_pre=nms_pre,
                      nms_type=nms_type, sigma=sigma, min_score=min_score,
                      method=method)


def dense_class_nms(bboxes, scores, score_thr, iou_thr, max_per_img,
                    valid=None) -> NMSResult:
    """`batched_dense_class_nms` for one image."""
    return _one_image(batched_dense_class_nms, bboxes, scores, valid,
                      score_thr, iou_thr, max_per_img)


def class_sorted_nms(bboxes, scores, score_thr, iou_thr, max_per_img,
                     class_pre=256, valid=None) -> NMSResult:
    """`batched_class_sorted_nms` for one image."""
    return _one_image(batched_class_sorted_nms, bboxes, scores, valid,
                      score_thr, iou_thr, max_per_img, class_pre=class_pre)


def lane_topk_select(bboxes: torch.Tensor,
                     scores: torch.Tensor,
                     score_thr: float,
                     k_per_lane: int = 2,
                     lanes: int = 128,
                     valid: Optional[torch.Tensor] = None):
    """Per-class candidate selection without a sort: the top
    ``k_per_lane`` scores of every ``lanes``-wide column of the candidate
    axis, ties at the first occurrence.

    Args:
        bboxes: (B, N, 4) boxes shared across classes.
        scores: (B, N, C) per-class scores, no background column.
        valid: optional (B, N) bool mask of real boxes.

    Returns:
        ``(svals (B, C, P), cand_boxes (B, C, P, 4))`` with
        ``P = lanes * k_per_lane``; empty slots have ``svals == NEG_INF``.
    """
    b, n, num_classes = scores.shape
    v = scores > score_thr
    if valid is not None:
        v = v & valid[..., None]
    st = torch.where(v, scores, torch.full_like(scores, NEG_INF))
    st = st.transpose(1, 2)  # (B, C, N)
    pad = (-n) % lanes
    if pad:
        st = F.pad(st, (0, pad), value=NEG_INF)
        bboxes = F.pad(bboxes, (0, 0, 0, pad))
    s = st.shape[-1] // lanes
    x = st.reshape(b, num_classes, s, lanes)
    bbs = bboxes.reshape(b, 1, s, lanes, 4)
    svals, cands = [], []
    for _ in range(k_per_lane):
        m = torch.amax(x, dim=2)  # (B, C, lanes)
        is_max = x == m[:, :, None, :]
        first = torch.cumsum(is_max, dim=2) == 1  # ties: lowest index
        pick = is_max & first  # one-hot over the sublane axis
        # exact payload pull: select, then sum one value with zeros
        cand = torch.where(pick[..., None], bbs, 0.).sum(dim=2)
        svals.append(m)
        cands.append(cand)
        x = torch.where(pick, torch.full_like(x, NEG_INF), x)
    return torch.cat(svals, dim=-1), torch.cat(cands, dim=2)


def batched_class_lane_nms(bboxes: torch.Tensor,
                           scores: torch.Tensor,
                           score_thr: float,
                           iou_thr: float,
                           max_per_img: int,
                           lane_pre: int = 4,
                           class_pre: int = 0,
                           valid: Optional[torch.Tensor] = None
                           ) -> NMSResult:
    """Class-aware NMS with lane-local budgets over a batch: the lane
    preselection, then (with ``class_pre``) an exact per-class top
    ``class_pre`` of it, then one blocked greedy walk over all classes at
    once, each class's boxes offset so that classes never overlap.

    Args:
        bboxes: (B, N, 4); scores: (B, N, C); valid: optional (B, N).
    """
    b, _, num_classes = scores.shape
    svals, cand_boxes = lane_topk_select(bboxes, scores, score_thr,
                                         k_per_lane=lane_pre, valid=valid)
    if 0 < class_pre < svals.shape[-1]:
        svals, order = torch.sort(svals, dim=-1, descending=True,
                                  stable=True)
        svals = svals[..., :class_pre]
        order = order[..., :class_pre]
        cand_boxes = torch.gather(
            cand_boxes, 2, order[..., None].expand(*order.shape, 4))
    p = svals.shape[-1]
    return _offset_nms(svals.reshape(b, num_classes * p),
                       cand_boxes.reshape(b, num_classes * p, 4), p,
                       iou_thr, max_per_img)


def class_lane_nms(bboxes, scores, score_thr, iou_thr, max_per_img,
                   lane_pre=4, class_pre=0, valid=None) -> NMSResult:
    """`batched_class_lane_nms` for one image: bboxes (N, 4), scores
    (N, C), valid (N,); returns (max_per_img, ...) rows."""
    return _one_image(batched_class_lane_nms, bboxes, scores, valid,
                      score_thr, iou_thr, max_per_img, lane_pre=lane_pre,
                      class_pre=class_pre)
