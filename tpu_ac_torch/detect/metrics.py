"""Detection metrics on the host, without sklearn (port of
``tpu_ac.detect.metrics``): image-level AUROC and pixel-level AUROC with
the optimal-F1 threshold statistics, and the PRO score.

``tpu_ac`` calls sklearn's ``roc_curve``, ``roc_auc_score`` and
``precision_recall_curve``; the card's machine has no sklearn, so their
binary, unweighted cases are written here in numpy: scores sorted
descending (stable), one curve point per distinct score, counts in
float64.  ``roc_curve`` drops the collinear points
(``drop_intermediate=True``, sklearn's default) and starts at (0, 0) with
threshold +inf; the AUROC is the trapezoid under it; with one class
present the AUROC is nan, as sklearn returns it (with a warning).
``compute_pro`` is numpy + ``scipy.ndimage``, copied.
"""

from __future__ import annotations

import warnings

import numpy as np


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, descending."""
    y_true = np.asarray(y_true).ravel() == 1
    y_score = np.asarray(y_score).ravel()
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    last = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[last]
    fps = 1.0 + last - tps
    return fps, tps, y_score[last]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve`` gives them
    for a binary y_true with the default ``drop_intermediate=True``."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score) -> float:
    if len(np.unique(np.asarray(y_true))) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.")
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(np.trapezoid(tpr, fpr))


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) as
    ``sklearn.metrics.precision_recall_curve`` gives them (binary,
    ``drop_intermediate=False``): recall decreasing, ending at (1, 0)."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            thresholds[::-1])


def compute_imagewise_retrieval_metrics(anomaly_prediction_weights,
                                        anomaly_ground_truth_labels) -> dict:
    """Image-level AUROC/FPR/TPR (metrics.py:6-25)."""
    fpr, tpr, thresholds = roc_curve(anomaly_ground_truth_labels,
                                     anomaly_prediction_weights)
    auroc = roc_auc_score(anomaly_ground_truth_labels,
                          anomaly_prediction_weights)
    return {"auroc": auroc, "fpr": fpr, "tpr": tpr, "threshold": thresholds}


def compute_pixelwise_retrieval_metrics(anomaly_segmentations,
                                        ground_truth_masks) -> dict:
    """Pixel AUROC + optimal-F1-threshold FPR/FNR (metrics.py:28-76)."""
    if isinstance(anomaly_segmentations, list):
        anomaly_segmentations = np.stack(anomaly_segmentations)
    if isinstance(ground_truth_masks, list):
        ground_truth_masks = np.stack(ground_truth_masks)

    flat_scores = anomaly_segmentations.ravel()
    flat_truth = ground_truth_masks.ravel().astype(int)

    fpr, tpr, _ = roc_curve(flat_truth, flat_scores)
    auroc = roc_auc_score(flat_truth, flat_scores)

    precision, recall, pr_thresholds = precision_recall_curve(flat_truth,
                                                              flat_scores)
    f1 = np.divide(2 * precision * recall, precision + recall,
                   out=np.zeros_like(precision),
                   where=(precision + recall) != 0)
    optimal_threshold = pr_thresholds[np.argmax(f1)]
    predictions = (flat_scores >= optimal_threshold).astype(int)
    return {
        "auroc": auroc,
        "fpr": fpr,
        "tpr": tpr,
        "optimal_threshold": optimal_threshold,
        "optimal_fpr": float(np.mean(predictions > flat_truth)),
        "optimal_fnr": float(np.mean(predictions < flat_truth)),
    }


def compute_pro(anomaly_segmentations, ground_truth_masks,
                fpr_limit: float = 0.3) -> float:
    """Per-Region-Overlap AUC up to ``fpr_limit``, normalized to [0, 1].

    The PRO score of Bergmann et al. For each threshold, the overlap of the
    binarized prediction with EVERY connected anomaly region is averaged
    (so small defects count as much as large ones), plotted against the
    false-positive rate on normal pixels, and integrated up to
    ``fpr_limit`` (0.3 in the paper), normalized by that limit.

    Exact O(N log N) computation: every pixel of region r contributes
    1/(n_regions * |r|) to the mean region overlap the moment the
    threshold passes its score, so both curves are cumulative sums over
    the pixels sorted by score descending; ties are collapsed to one
    curve point (a threshold set cannot split equal scores).
    """
    from scipy import ndimage

    if isinstance(anomaly_segmentations, list):
        anomaly_segmentations = np.stack(anomaly_segmentations)
    if isinstance(ground_truth_masks, list):
        ground_truth_masks = np.stack(ground_truth_masks)
    masks = ground_truth_masks.astype(bool)

    # per-pixel weight: 1/(n_regions_total * |region(pixel)|), 0 for normal
    weights = np.zeros(anomaly_segmentations.shape, np.float64)
    n_regions = 0
    for i in range(masks.shape[0]):
        labels, n = ndimage.label(masks[i])
        for r in range(1, n + 1):
            region = labels == r
            weights[i][region] = 1.0 / region.sum()
        n_regions += n
    if n_regions == 0:
        raise ValueError("compute_pro needs at least one anomaly region")
    weights /= n_regions

    scores = anomaly_segmentations.ravel()
    weights = weights.ravel()
    normal = ~masks.ravel()
    n_normal = int(normal.sum())
    if n_normal == 0:
        raise ValueError("compute_pro needs normal pixels for the FPR axis")

    order = np.argsort(-scores, kind="stable")
    pro_curve = np.cumsum(weights[order])
    fpr_curve = np.cumsum(normal[order]) / n_normal
    # collapse ties: only the LAST index of each equal-score run is a
    # reachable operating point
    s_sorted = scores[order]
    last_of_run = np.r_[s_sorted[1:] != s_sorted[:-1], True]
    pro_curve = pro_curve[last_of_run]
    fpr_curve = fpr_curve[last_of_run]

    # prepend the (0, 0) operating point, clip at fpr_limit by linear
    # interpolation of the PRO value there, then trapezoid-integrate
    fpr = np.r_[0.0, fpr_curve]
    pro = np.r_[0.0, pro_curve]
    keep = fpr < fpr_limit
    pro_at_limit = np.interp(fpr_limit, fpr, pro)
    fpr = np.r_[fpr[keep], fpr_limit]
    pro = np.r_[pro[keep], pro_at_limit]
    return float(np.trapezoid(pro, fpr) / fpr_limit)
