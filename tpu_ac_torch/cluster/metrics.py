"""Host-side clustering + metrics (port of ``tpu_ac.cluster.metrics``).

Agglomerative (ward) clustering, Hungarian relabeling and NMI/ARI/F1 run on
[N <= ~170] arrays with numpy and scipy alone; SCAN's ``hungarian_evaluate``
(ACC, Top-5, NMI, ARI) on its [N, C] class probabilities.  ``tpu_ac`` calls sklearn
here; sklearn's ward clustering is scipy's ``hierarchy.ward`` tree cut by
``_hc_cut``, and its scores are closed forms over the contingency table, so
this module computes the same values in the same order of operations
(tests/test_torch_metrics.py holds them equal to sklearn's).  ``best_map``
solves the assignment on -G^T with the native JV solver
(``tpu_ac_torch.native``), as ``tpu_ac`` does, and with scipy's
``linear_sum_assignment`` on a machine without a C++ compiler.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
from scipy.cluster import hierarchy
from scipy.optimize import linear_sum_assignment

from tpu_ac_torch import native


def contingency(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Square G[i, j] = |labels==L1[i] & preds==L2[j]| (classes sorted,
    padded to max(#label classes, #pred classes))."""
    table = _count_table(labels, preds)
    g = np.zeros((max(table.shape),) * 2, dtype=np.float64)
    g[:table.shape[0], :table.shape[1]] = table
    return g


def best_map(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Relabel cluster ids to maximize agreement (Hungarian on -G^T);
    returns preds mapped into label space."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    cost = -contingency(labels, preds).T
    if native.get_lib() is not None:  # tpu_ac's order: the JV solver first
        cols, _ = native.hungarian(cost)
        rows = np.arange(len(cols))
    else:
        rows, cols = linear_sum_assignment(cost)
    l1 = np.unique(labels)
    l2 = np.unique(preds)
    # pad label values when there are more clusters than label classes
    pad = [v for v in range(len(l2)) if v not in set(l1)]
    l1_padded = (np.concatenate([l1, np.asarray(pad, dtype=l1.dtype)])
                 if pad else l1)
    mapping = {row: l1_padded[col] for row, col in zip(rows, cols)}
    out = np.zeros(preds.shape, dtype=labels.dtype)
    for j, b in enumerate(l2):
        out[preds == b] = mapping[j]
    return out


def _count_table(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Unpadded int64 contingency [#classes, #clusters]."""
    _, ci = np.unique(labels, return_inverse=True)
    _, ki = np.unique(preds, return_inverse=True)
    table = np.zeros((ci.max() + 1, ki.max() + 1), dtype=np.int64)
    np.add.at(table, (ci, ki), 1)
    return table


def _entropy(labels: np.ndarray) -> float:
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - math.log(pi_sum))))


def normalized_mutual_info(labels: np.ndarray, preds: np.ndarray) -> float:
    """NMI with the arithmetic-mean normalizer (natural log), as
    sklearn's ``normalized_mutual_info_score``."""
    table = _count_table(labels, preds)
    if table.shape[0] == table.shape[1] == 1:
        return 1.0  # neither labeling splits the data: a perfect match
    if table.shape[0] == 1 or table.shape[1] == 1:
        return 0.0
    nzx, nzy = np.nonzero(table)  # row-major, the order sklearn sums in
    nz_val = table[nzx, nzy]
    total = table.sum()
    pi = table.sum(axis=1)
    pj = table.sum(axis=0)
    log_nz = np.log(nz_val)
    p_nz = nz_val / total
    outer = pi.take(nzx) * pj.take(nzy)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    mi = p_nz * (log_nz - math.log(total)) + p_nz * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    mi = float(np.clip(mi.sum(), 0.0, None))
    if mi == 0:
        return 0.0
    return float(mi / np.mean([_entropy(labels), _entropy(preds)]))


def adjusted_rand(labels: np.ndarray, preds: np.ndarray) -> float:
    """ARI from the pair confusion matrix, as sklearn's
    ``adjusted_rand_score``."""
    table = _count_table(labels, preds)
    n = int(table.sum())
    n_c, n_k = table.sum(axis=1), table.sum(axis=0)
    sum_sq = int((table ** 2).sum())
    tp = sum_sq - n
    fp = int((table @ n_k).sum()) - sum_sq
    fn = int((table.T @ n_c).sum()) - sum_sq
    tn = n * n - fp - fn - sum_sq
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                       + (tp + fp) * (fp + tn))


def clustering_scores(labels: np.ndarray, preds: np.ndarray
                      ) -> dict[str, float]:
    """NMI / ARI / micro-F1 of best-mapped predictions.  Micro-F1 over
    single-label predictions is 2 tp / (2 n), the accuracy."""
    labels = np.asarray(labels)
    preds = best_map(labels, np.asarray(preds)).astype(int)
    correct = int(np.sum(labels == preds))
    return {
        "NMI": normalized_mutual_info(labels, preds),
        "ARI": adjusted_rand(labels, preds),
        "F1": float(np.float64(2 * correct) / (2 * len(labels))),
    }


def agglomerative_cluster(X: np.ndarray, n_clusters: int) -> np.ndarray:
    """Ward clustering: scipy's ward tree cut into ``n_clusters`` by
    splitting the newest merge first (sklearn's ``_hc_cut``, so the labels
    are sklearn's ``AgglomerativeClustering(n_clusters).fit_predict``)."""
    X = np.asarray(X)
    n = X.shape[0]
    if not 1 <= n_clusters <= n:
        raise ValueError(f"n_clusters {n_clusters} for {n} samples")
    children = hierarchy.ward(X)[:, :2].astype(np.intp)
    heads = [-(int(max(children[-1])) + 1)]  # negated: a max-heap
    for _ in range(n_clusters - 1):
        a, b = children[-heads[0] - n]
        heapq.heappush(heads, -int(a))
        heapq.heappushpop(heads, -int(b))
    labels = np.zeros(n, dtype=np.intp)
    for k, head in enumerate(heads):
        stack = [-head]
        while stack:
            node = stack.pop()
            if node < n:
                labels[node] = k
            else:
                stack.extend(children[node - n])
    return labels


def encode_labels(label_strings: list[str]) -> np.ndarray:
    """LabelEncoder equivalent: sorted-unique string -> int."""
    lut = {c: i for i, c in enumerate(sorted(set(label_strings)))}
    return np.asarray([lut[s] for s in label_strings], dtype=int)


def hungarian_match(preds: np.ndarray, targets: np.ndarray,
                    num_k: int) -> list[tuple[int, int]]:
    """IIC-style one-to-one cluster->class match (_hungarian_match,
    Unsupervised-Classification-master/utils/evaluate_utils.py:162-186):
    [(pred_cluster, target_class), ...] maximizing vote agreement."""
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    num_correct = np.zeros((num_k, num_k))
    for c1 in range(num_k):
        for c2 in range(num_k):
            num_correct[c1, c2] = int(((preds == c1) & (targets == c2)).sum())
    rows, cols = linear_sum_assignment(len(targets) - num_correct)
    return list(zip(rows.tolist(), cols.tolist()))


def hungarian_evaluate(probs: np.ndarray, targets: np.ndarray,
                       compute_confusion_matrix: bool = False
                       ) -> dict[str, object]:
    """SCAN's hungarian evaluation with Top-5 (hungarian_evaluate,
    evaluate_utils.py:122-159) on one head's [N, C] probabilities:
    {'ACC', 'NMI', 'ARI', 'ACC Top-5', 'hungarian_match'}.  ACC and Top-5
    use the match-remapped cluster ids; NMI and ARI the raw predictions
    (both are permutation-invariant), as the reference does (PARITY #17);
    they come from ``normalized_mutual_info`` and ``adjusted_rand``, which
    compute sklearn's scores."""
    probs = np.asarray(probs)
    targets = np.asarray(targets)
    preds = probs.argmax(axis=1)
    num_classes = len(np.unique(targets))
    match = hungarian_match(preds, targets, num_classes)

    remap = np.zeros(max(num_classes, probs.shape[1]), dtype=np.int64)
    for pred_i, target_i in match:
        remap[pred_i] = target_i
    reordered = remap[preds]
    acc = float(np.mean(reordered == targets))
    nmi = normalized_mutual_info(targets, preds)
    ari = float(adjusted_rand(targets, preds))

    # Top-5 over match-remapped class probabilities (evaluate_utils.py:
    # 146-151; the reference's topk(5) assumes >= 5 clusters: clamped)
    k = min(5, probs.shape[1])
    top_k = np.argsort(-probs, axis=1)[:, :k]
    reordered_top_k = remap[top_k]
    top5 = float(np.mean((reordered_top_k == targets[:, None]).any(axis=1)))

    out: dict[str, object] = {"ACC": acc, "NMI": nmi, "ARI": ari,
                              "ACC Top-5": top5, "hungarian_match": match}
    if compute_confusion_matrix:
        out["confusion_matrix"] = confusion_matrix(reordered, targets,
                                                   n_classes=num_classes)
    return out


def confusion_matrix(preds, labels, n_classes: int | None = None
                     ) -> np.ndarray:
    """[n_classes, n_classes] counts, rows = true, cols = predicted
    (Unsupervised-Classification-master/utils/utils.py:73-83)."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    if n_classes is None:
        n_classes = int(max(preds.max(), labels.max())) + 1
    m = np.zeros((n_classes, n_classes), dtype=np.int64)
    for t, p in zip(labels, preds):
        m[int(t), int(p)] += 1
    return m
