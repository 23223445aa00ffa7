"""Video-segmentation label propagation, the DAVIS eval workload (port of
``tpu_ac.train.video_seg``; dino-main/eval_video_segmentation.py:100-180).

Per target frame, attention between the target's patch features and a
context queue of earlier frames propagates their segmentation masks:
exp(sim/0.1) affinities, an optional spatial neighbourhood restriction,
top-k sparsification over the sources and affinity-weighted label
averaging.  The propagation step runs on the features' device in f32 with
TF32 off (the affinity's 1/0.1 would amplify TF32's rounding into the
top-k); the video loop (the queue) stays on the host, as the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ac_torch.device import precision_scope
from tpu_ac_torch.ops.normalize import l2_normalize


@functools.lru_cache(maxsize=8)
def restrict_neighborhood(h: int, w: int, size: int) -> np.ndarray:
    """[h*w, h*w] binary mask allowing attention within a (2*size+1)^2
    spatial window (eval_video_segmentation.py:70-83)."""
    mask = np.zeros((h, w, h, w), np.float32)
    for i in range(h):
        for j in range(w):
            lo_i, hi_i = max(0, i - size), min(h, i + size + 1)
            lo_j, hi_j = max(0, j - size), min(w, j + size + 1)
            mask[i, j, lo_i:hi_i, lo_j:hi_j] = 1.0
    return mask.reshape(h * w, h * w)


def _neighborhood_mask(h: int, w: int, size: int,
                       device: torch.device) -> torch.Tensor:
    """:func:`restrict_neighborhood` computed on ``device``: the window
    [max(0, i-size), min(h, i+size+1)) is exactly |di| <= size."""
    idx = torch.arange(h * w, device=device)
    qi, qj = idx // w, idx % w
    return ((torch.abs(qi[:, None] - qi[None, :]) <= size)
            & (torch.abs(qj[:, None] - qj[None, :]) <= size)
            ).to(torch.float32)


def propagate_labels(feat_tar: torch.Tensor, context_feats: torch.Tensor,
                     context_segs: torch.Tensor, *, grid: tuple[int, int],
                     topk: int = 5, temperature: float = 0.1,
                     size_mask_neighborhood: int = 12) -> torch.Tensor:
    """One propagation step.

    Args:
        feat_tar: [h*w, D] target-frame patch features (CLS dropped).
        context_feats: [n_ctx, h*w, D] context-frame features.
        context_segs: [n_ctx, C, h, w] context soft segmentation masks.
        grid: (h, w) patch grid.
        topk: per-target-query top-k source sparsification.
        temperature: affinity softmax temperature.
        size_mask_neighborhood: spatial window radius (0 disables).
    Returns:
        [C, h, w] propagated soft mask for the target frame.

    The sparsification keeps every source whose affinity reaches the
    query's k-th largest (``aff >= kth``), as ``tpu_ac`` does: sources
    tied with the k-th are all kept, so the result does not depend on how
    a top-k orders ties.
    """
    h, w = grid
    n_ctx = context_feats.shape[0]
    with precision_scope("highest"):
        ft = l2_normalize(feat_tar, dim=1)
        fs = l2_normalize(context_feats, dim=2)
        # aff[n, q, s] = exp(<tar_q, src_s>/T)
        aff = torch.exp(torch.einsum("qd,nsd->nqs", ft, fs) / temperature)
        if size_mask_neighborhood > 0:
            aff = aff * _neighborhood_mask(h, w, size_mask_neighborhood,
                                           aff.device)[None]
        # [n_ctx*s, q]: sparsify over sources per query, renormalize
        aff = aff.transpose(1, 2).reshape(n_ctx * h * w, h * w)
        kth = torch.topk(aff.T, topk, dim=1).values[:, -1]
        aff = torch.where(aff >= kth[None, :], aff, 0.0)
        aff = aff / torch.sum(aff, dim=0, keepdim=True)
        c = context_segs.shape[1]
        segs = context_segs.reshape(n_ctx, c, h * w).transpose(1, 2)
        segs = segs.reshape(n_ctx * h * w, c)  # [sources, C]
        out = segs.T @ aff  # [C, q]
    return out.reshape(c, h, w)


def norm_mask(mask: np.ndarray) -> np.ndarray:
    """Per-channel min-max normalization
    (eval_video_segmentation.py:100-108)."""
    out = mask.copy()
    for c in range(mask.shape[0]):
        m = out[c]
        if m.max() > 0:
            m = m - m.min()
            out[c] = m / m.max()
    return out


def to_one_hot(labels: np.ndarray, n_dims: int | None = None) -> np.ndarray:
    """[h, w] integer labels -> [C, h, w] one-hot
    (eval_video_segmentation.py:176-188)."""
    if n_dims is None:
        n_dims = int(labels.max() + 1)
    h, w = labels.shape
    out = np.zeros((n_dims, h, w), np.float32)
    for c in range(n_dims):
        out[c] = labels == c
    return out


def propagate_video(frame_features: list[torch.Tensor],
                    first_mask: np.ndarray, grid: tuple[int, int], *,
                    n_last_frames: int = 7, topk: int = 5,
                    size_mask_neighborhood: int = 12,
                    normalize: bool = True) -> list[np.ndarray]:
    """Propagate the first frame's mask through a video
    (eval_video_segmentation.py main loop: first frame + queue of the
    n_last_frames most recent predictions as context).

    frame_features: per frame [h*w, D] (tensors on one device, or host
    arrays, which run on the host); first_mask: [C, h, w] one-hot.
    Returns per-frame [C, h, w] soft masks on the host (index 0 = the
    given mask).  ``normalize=False`` returns the RAW propagated masks —
    the DAVIS CLI needs them because the reference upsamples by
    patch_size FIRST and norm_masks at pixel resolution
    (eval_video_segmentation.py:76-78).
    """
    feats = [torch.as_tensor(f) for f in frame_features]
    dev = feats[0].device
    first = (feats[0], torch.as_tensor(np.asarray(first_mask)).to(dev))
    que: list[tuple[torch.Tensor, torch.Tensor]] = []
    out = [np.asarray(first_mask)]
    for feat in feats[1:]:
        used = [first] + que[-n_last_frames:]
        seg = propagate_labels(feat, torch.stack([u[0] for u in used]),
                               torch.stack([u[1] for u in used]),
                               grid=grid, topk=topk,
                               size_mask_neighborhood=size_mask_neighborhood)
        # the RAW propagated mask feeds the queue; norm_mask applies only
        # to the returned copy (eval_video_segmentation.py:70-75 queues
        # deepcopy(frame_tar_avg) BEFORE interpolate + norm_mask)
        que.append((feat, seg))
        seg_np = seg.cpu().numpy()
        out.append(norm_mask(seg_np) if normalize else seg_np)
    return out
