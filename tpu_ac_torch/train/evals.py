"""DINO evaluation suites (port of ``tpu_ac.train.evals``).

Rebuilds of dino-main's eval workloads:

- feature extraction: batches of one device, or split over the ranks of a
  ``distributed.Mesh`` and gathered back (the reference's per-rank
  extraction + ``all_gather``, eval_knn.py:96-139);
- k-NN classification (eval_knn.py:142-183): the temperature-weighted
  cosine vote, TF32 off (ties in the top-k flip under TF32), the bank on
  the device once for every k;
- the linear probe (eval_linear.py:31-281): an SGD linear classifier on
  frozen features, optax's chain on the port's ``train/optim.py``;
- PCA whitening (dino-main/utils.py:654-705) and retrieval AP/mAP
  (utils.py:708-812), numpy copies of ``tpu_ac``'s;
- multi_scale feature ensembling (utils.py:815-829).
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_ac_torch.data.mvtec import normalize_on_device
from tpu_ac_torch.data.prefetch import to_device
from tpu_ac_torch.device import precision_scope, resolve_device
from tpu_ac_torch.distributed.mesh import Mesh, get_mesh, shard_batch
from tpu_ac_torch.ops.interpolate import interpolate_bilinear
from tpu_ac_torch.ops.normalize import l2_normalize
from tpu_ac_torch.train import optim
from tpu_ac_torch.utils.checkpoint import tree_flatten, tree_unflatten


# ranks of a CPU run's --dp mesh where the CLI gives no count: the host
# repeated, its ranks run one after another (the sharded code path)
CPU_DP = 2


def eval_mesh(device: torch.device, dp: int | None = None) -> Mesh:
    """The ``--dp`` mesh of the eval CLIs: ``dp`` cards (every visible
    card when None), or on the CPU the host repeated ``dp`` (``CPU_DP``)
    times."""
    if device.type == "cpu":
        return Mesh([device] * (dp or CPU_DP))
    return get_mesh(dp)


def _canonical(device) -> torch.device:
    """``device`` as a tensor placed there reports it (``cuda`` ->
    ``cuda:0``), so it can key a table looked up by ``x.device``."""
    return torch.empty(0, device=device).device


def module_replicas(model: torch.nn.Module, mesh: Mesh
                    ) -> dict[torch.device, torch.nn.Module]:
    """One copy of ``model`` on each distinct device of ``mesh``, keyed by
    the device a shard placed there reports; ``model`` itself where it
    already lies."""
    home = next(model.parameters()).device
    out = {}
    for d in mesh.distinct_devices:
        key = _canonical(d)
        out[key] = model if key == home else copy.deepcopy(model).to(key)
    return out


def make_embedder(model: torch.nn.Module, forward,
                  mesh: Mesh | None = None) -> Callable:
    """batch (uint8, on a device) -> ``forward(model there, normalized
    batch)`` under ``precision_scope("default")`` (TF32 on the card,
    ``tpu_ac``'s ``Precision.DEFAULT`` of its eval forwards); over a mesh,
    each rank runs its own replica."""
    replicas = module_replicas(model, mesh) if mesh is not None else None

    def embed(x: torch.Tensor) -> torch.Tensor:
        m = replicas[x.device] if replicas is not None else model
        with precision_scope("default"):
            return forward(m, normalize_on_device(x))

    return embed


def extract_features(embed_fn: Callable, images: np.ndarray,
                     batch_size: int = 64, normalize: bool = True,
                     mesh: Mesh | None = None,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Batched feature extraction (eval_knn.py:96-139): [N, D] float32 on
    the host.

    ``embed_fn(x)`` maps a batch on a device to its features there.
    ``images`` is a host array (uint8 or float); each batch is uploaded
    from pinned memory.  With ``mesh`` each batch is split over its ranks
    (``shard_batch``), each rank's shard embedded on the rank's device by
    ``embed_fn`` and the features gathered back in rank order, the
    reference's per-rank extraction + ``all_gather``; ``batch_size`` must
    divide over the mesh.  The host copy of a batch's features waits one
    batch, so the device embeds batch i+1 while i is copied.
    """
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh "
                         f"size {mesh.size}")
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    upload = to_device(dev)
    n = images.shape[0]
    feats: list[np.ndarray] = []
    pending = None
    for i in range(0, n, batch_size):
        batch = np.ascontiguousarray(images[i:i + batch_size])
        if mesh is None:
            f = embed_fn(upload(batch))
        else:
            shards, n_valid = shard_batch(mesh, batch)
            f = torch.cat([embed_fn(s).to(dev) for s in shards])[:n_valid]
        if normalize:
            f = l2_normalize(f, dim=1)
        if pending is not None:
            feats.append(pending.cpu().numpy())
        pending = f
    if pending is not None:
        feats.append(pending.cpu().numpy())
    return np.concatenate(feats).astype(np.float32, copy=False)


def _on(x, dev: torch.device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(dev, dtype)


def _vote(q: torch.Tensor, bank: torch.Tensor, labels: torch.Tensor,
          k: int, T: float, num_classes: int) -> torch.Tensor:
    """[b, C] class weights of the k nearest bank rows: exp(sim/T) summed
    per class through a one-hot, as ``tpu_ac``'s ``chunk_probs``."""
    sims = q @ bank.T
    top_sims, idx = torch.topk(sims, k, dim=1)
    onehot = F.one_hot(labels[idx], num_classes).to(q.dtype)  # [b, k, C]
    return torch.sum(onehot * torch.exp(top_sims / T)[..., None], dim=1)


def knn_predictions(train_features, train_labels, test_features, k: int,
                    T: float, num_classes: int = 1000,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """The weighted k-NN vote's classes, best first: [N_test, min(5, k,
    num_classes)].

    Features and labels are tensors, which run where the bank lies, or
    host arrays, which go to ``device`` once.  The queries
    go in chunks of ``len(test) // 100``; each chunk's similarity product
    runs with TF32 off, then top-k, the one-hot sum and a host argsort of
    the class weights (``tpu_ac``'s order of work).  The argsort of chunk
    i runs while the device computes chunk i+1."""
    if isinstance(train_features, torch.Tensor):
        dev = train_features.device
    else:
        dev = resolve_device(device)
    bank = _on(train_features, dev, torch.float32)
    labels = _on(train_labels, dev, torch.int64)
    queries = _on(test_features, dev, torch.float32)
    n = queries.shape[0]
    kk = min(5, k, num_classes)
    out = np.empty((n, kk), np.int64)
    chunk = max(1, n // 100)

    def finish(start, probs, event):
        if event is not None:
            event.synchronize()
        order = np.argsort(-probs.numpy(), axis=1)
        out[start:start + order.shape[0]] = order[:, :kk]

    pending = None
    with precision_scope("highest"):
        for i in range(0, n, chunk):
            probs = _vote(queries[i:i + chunk], bank, labels, k, T,
                          num_classes)
            event = None
            if dev.type == "cuda":
                host = torch.empty(probs.shape, dtype=probs.dtype,
                                   pin_memory=True)
                host.copy_(probs, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                probs = host
            if pending is not None:
                finish(*pending)
            pending = (i, probs, event)
    if pending is not None:
        finish(*pending)
    return out


def knn_classifier(train_features, train_labels, test_features,
                   test_labels, k: int, T: float, num_classes: int = 1000,
                   device: str | torch.device = "cuda"
                   ) -> tuple[float, float]:
    """Weighted k-NN vote (eval_knn.py:142-183): cosine top-k, exp(sim/T)
    weights, one-hot sum.  Returns (top1, top5) percentages."""
    order = knn_predictions(train_features, train_labels, test_features, k,
                            T, num_classes, device)
    targets = np.asarray(test_labels)
    top1 = int(np.sum(order[:, 0] == targets))
    top5 = int(np.sum(order == targets[:, None]))
    return 100.0 * top1 / len(targets), 100.0 * top5 / len(targets)


class LinearProbeState(NamedTuple):
    weight: torch.Tensor
    bias: torch.Tensor
    opt_state: object


def _probe_optimizer(momentum: float, weight_decay: float
                     ) -> optim.GradientTransformation:
    # optax.chain(add_decayed_weights(wd), sgd(1.0, momentum)); the lr
    # multiplies the updates in the step
    return optim.chain(optim.add_decayed_weights(weight_decay),
                       optim.sgd(1.0, momentum=momentum))


def _probe_loss_and_grads(w, b, feats, labels):
    w = w.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = F.cross_entropy(feats @ w.T + b, labels)
        gw, gb = torch.autograd.grad(loss, (w, b))
    return loss.detach(), gw, gb


def make_linear_probe(feature_dim: int, num_classes: int, lr: float = 0.001,
                      momentum: float = 0.9, weight_decay: float = 0.0,
                      seed: int = 0, mesh: Mesh | None = None,
                      device: str | torch.device = "cuda"):
    """Linear probe on frozen features (eval_linear.py:237-254; the init
    is ``tpu_ac``'s: numpy ``standard_normal`` x 0.01, bias zero; SGD with
    momentum).

    Returns (state, train_step(state, feats, labels, lr) -> (state, loss),
    predict(state, feats) -> logits), the state on ``device``.

    With ``mesh`` the probe trains data-parallel, as the reference's DDP
    LinearClassifier (eval_linear.py:62): each step's batch is split over
    the ranks, each rank's mean loss and gradients are taken on its device
    against the state's copy there, and the gradients are averaged (the
    global-batch mean at equal shard sizes).  The per-step batch must be
    divisible by the mesh size; the state lives on the mesh's first device.
    """
    rng = np.random.default_rng(seed)
    w_np = (rng.standard_normal((num_classes, feature_dim)) * 0.01
            ).astype(np.float32)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    w = torch.from_numpy(w_np).to(dev)
    b = torch.zeros(num_classes, dtype=torch.float32, device=dev)
    opt = _probe_optimizer(momentum, weight_decay)
    state = LinearProbeState(w, b, opt.init({"w": w, "b": b}))

    def train_step(state: LinearProbeState, feats: torch.Tensor,
                   labels: torch.Tensor, lr: float):
        if mesh is None:
            loss, gw, gb = _probe_loss_and_grads(
                state.weight, state.bias, feats.to(dev), labels.to(dev))
        else:
            if feats.shape[0] % mesh.size:
                raise ValueError(
                    f"batch of {feats.shape[0]} not divisible by the "
                    f"{mesh.size}-way data-parallel axis (--dp)")
            f_sh, _ = shard_batch(mesh, feats)
            y_sh, _ = shard_batch(mesh, labels)
            parts = [_probe_loss_and_grads(state.weight.to(d),
                                           state.bias.to(d), f, y)
                     for f, y, d in zip(f_sh, y_sh, mesh.devices)]
            loss, gw, gb = (sum(p[j].to(dev) for p in parts) / mesh.size
                            for j in range(3))
        params = {"w": state.weight, "b": state.bias}
        updates, opt_state = opt.update({"w": gw, "b": gb}, state.opt_state,
                                        params)
        updates = dict(zip(updates, torch._foreach_mul(
            list(updates.values()), lr)))
        params = optim.apply_updates(params, updates)
        return LinearProbeState(params["w"], params["b"], opt_state), loss

    def predict(state: LinearProbeState, feats: torch.Tensor
                ) -> torch.Tensor:
        return feats.to(dev) @ state.weight.T + state.bias

    return state, train_step, predict


def probe_state_from_numpy(tree, momentum: float = 0.9,
                           weight_decay: float = 0.0,
                           device: str | torch.device = "cuda"
                           ) -> LinearProbeState:
    """A ``LinearProbeState`` of either package whose leaves are numpy
    arrays -> the port's state on ``device``.  The optimizer state's
    leaves are taken in ``jax.tree.flatten`` order: optax's momentum trace
    of {"b", "w"}, keys sorted, which the port's chain shares."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    w, b = t(tree.weight), t(tree.bias)
    template = _probe_optimizer(momentum, weight_decay).init({"w": w,
                                                             "b": b})
    opt_state = tree_unflatten(template,
                               [t(a) for a in tree_flatten(tree.opt_state)])
    return LinearProbeState(w, b, opt_state)


def probe_state_to_numpy(state: LinearProbeState) -> LinearProbeState:
    """The port's probe state with every leaf as a numpy array."""
    leaves = [x.detach().cpu().numpy() for x in tree_flatten(tuple(state))]
    return LinearProbeState(*tree_unflatten(tuple(state), leaves))


class PCA:
    """PCA + whitening (dino-main/utils.py:654-705)."""

    def __init__(self, dim: int = 256, whit: float = 0.5):
        self.dim = dim
        self.whit = whit
        self.mean: np.ndarray | None = None
        self.dvt: np.ndarray | None = None

    def train_pca(self, cov: np.ndarray) -> None:
        d, v = np.linalg.eigh(cov)
        eps = d.max() * 1e-5
        d[d < eps] = eps
        idx = np.argsort(d)[::-1][:self.dim]
        d, v = d[idx], v[:, idx]
        self.dvt = np.diag(1.0 / d ** self.whit) @ v.T

    def fit(self, x: np.ndarray) -> None:
        """Convenience: center + covariance + train."""
        self.mean = x.mean(axis=0)
        xc = x - self.mean
        self.train_pca(xc.T @ xc / len(xc))

    def apply(self, x: np.ndarray) -> np.ndarray:
        if self.mean is not None:
            x = x - self.mean
        return (self.dvt @ x.T).T


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """Average precision from zero-based positive ranks (utils.py:708-739)."""
    ap = 0.0
    recall_step = 1.0 / nres
    for j, rank in enumerate(ranks):
        precision_0 = 1.0 if rank == 0 else float(j) / rank
        precision_1 = float(j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(ranks: np.ndarray, gnd: list[dict], kappas=()) -> tuple:
    """mAP / per-query AP / precision@kappa (utils.py:742-812).

    ranks: [db_size, n_queries] zero-based ranking; gnd[i] dicts with 'ok'
    (positives) and optional 'junk' indices.
    """
    mAP = 0.0
    nq = len(gnd)
    aps = np.zeros(nq)
    pr = np.zeros(len(kappas))
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    for i in range(nq):
        qgnd = np.asarray(gnd[i]["ok"])
        if qgnd.shape[0] == 0:
            aps[i] = float("nan")
            prs[i, :] = float("nan")
            nempty += 1
            continue
        qgndj = np.asarray(gnd[i].get("junk", []))
        pos = np.isin(ranks[:, i], qgnd).nonzero()[0]
        junk = (np.isin(ranks[:, i], qgndj).nonzero()[0]
                if qgndj.size else np.asarray([], dtype=int))
        if junk.size:
            # shift positive ranks down by the number of junk before them
            pos = pos - np.searchsorted(junk, pos)
        ap = compute_ap(pos, len(qgnd))
        mAP += ap
        aps[i] = ap
        # precision@kappa with the reference's kq truncation
        # (utils.py:804-806): 1-based positions, denominator
        # min(max(pos), kappa)
        pos1 = pos + 1
        for j, kappa in enumerate(kappas):
            kq = min(int(pos1.max()), kappa) if pos1.size else kappa
            prs[i, j] = (pos1 <= kq).sum() / kq if kq else 0.0
        pr += prs[i, :]
    denom = max(1, nq - nempty)
    return mAP / denom, aps, pr / denom, prs


def multi_scale(images: torch.Tensor, embed_fn: Callable) -> torch.Tensor:
    """Feature ensembling over scales 1, 1/sqrt(2), 1/2 (utils.py:815-829),
    the L2-normalized mean."""
    v = None
    for s in (1.0, 1.0 / (2 ** 0.5), 0.5):
        if s == 1.0:
            inp = images
        else:
            h = int(round(images.shape[2] * s / 2) * 2)
            w = int(round(images.shape[3] * s / 2) * 2)
            inp = interpolate_bilinear(images, size=(h, w))
        feats = embed_fn(inp)
        v = feats if v is None else v + feats
    v = v / 3
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def retrieval_ranks(query_features: np.ndarray,
                    db_features: np.ndarray) -> np.ndarray:
    """Similarity ranking for image retrieval: ranks [db_size, n_queries],
    ranks[r, q] = the db index at rank r for query q (inner products of
    the given features, on the host)."""
    sims = np.asarray(db_features) @ np.asarray(query_features).T
    return np.argsort(-sims, axis=0)


def revisited_retrieval_eval(query_features: np.ndarray,
                             db_features: np.ndarray, gnd: list[dict],
                             kappas=(1, 5, 10)) -> dict:
    """Revisited-Oxford/Paris Medium + Hard evaluation
    (dino-main/eval_image_retrieval.py:169-200): the features
    L2-normalized in float64, ranked by cosine; ``gnd`` the raw per-query
    easy/hard/junk ground truth.  Returns {"mAP_M", "mAP_H", "mP@k_M",
    "mP@k_H"} (fractions, not %)."""
    from tpu_ac_torch.data.oxford_paris import revisited_splits

    def l2n(x):
        x = np.asarray(x, np.float64)
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

    ranks = retrieval_ranks(l2n(query_features), l2n(db_features))
    gnd_m, gnd_h = revisited_splits(gnd)
    map_m, _, pr_m, _ = compute_map(ranks, gnd_m, kappas)
    map_h, _, pr_h, _ = compute_map(ranks, gnd_h, kappas)
    return {"mAP_M": float(map_m), "mAP_H": float(map_h),
            "mP@k_M": np.asarray(pr_m), "mP@k_H": np.asarray(pr_h)}


def image_retrieval_eval(query_features: np.ndarray,
                         db_features: np.ndarray, gnd: list[dict],
                         kappas=(1, 5, 10)) -> dict:
    """Rank + mAP + precision@k for a single difficulty split
    (dino-main/eval_image_retrieval.py:150-200)."""
    ranks = retrieval_ranks(query_features, db_features)
    m, aps, pr, _ = compute_map(ranks, gnd, kappas)
    return {"mAP": float(m), "aps": aps, "pr@k": pr}
