"""SCAN unsupervised classification (port of ``tpu_ac.train.scan``;
Unsupervised-Classification-master, ECCV'20).

The three stages (SimCLR pretext -> SCAN clustering -> self-labeling) as
train steps over the functional CIFAR ResNet:

- losses (losses/losses.py:11-165): SimCLR NT-Xent (SupContrast form),
  SCAN consistency-BCE minus weighted entropy, confidence-thresholded CE
  with class balancing for self-labeling;
- models (models/models.py:10-62): ``ContrastiveModel`` = backbone + MLP
  (or linear) head, ``ClusteringModel`` = backbone + n linear heads;
  ``nn.Module``s with the torch state_dict names, bound to a state on the
  meta device as ``models/resnet_cifar.py`` does;
- memory bank + faiss-IP neighbour mining (utils/memory.py:21-88): the
  features on the device, mined by ``ops.distances.knn_ip`` (or
  ``knn_ip_sharded`` over a ``Mesh``).

The state is ``tpu_ac``'s: ``SCANTrainState`` of flat dicts (params, BN
running statistics), the optimizer state of ``train/optim.py`` (optax's
leaves in optax's order) and the step.  A step is functional: it returns
a new state and leaves its argument as it was.  BatchNorm threads through
every forward explicitly: the SCAN step runs anchors and neighbours as two
forwards, the second starting from the statistics the first left.

Across processes (``train_dp: N`` over N cards, a ``torch.distributed``
group) each rank holds its shard of the batch and every loss is the one of
the global batch, as ``tpu_ac``'s jit over the sharded batch computes it:
BatchNorm's statistics (``models/resnet_cifar.py``), SimCLR's negatives
(every rank's features, gathered with their gradient), SCAN's entropy of
the mean prediction and self-labeling's class counts and weights span the
ranks; each rank's loss is written so that the global loss is the ranks'
mean, the gradients are averaged over the ranks before the optimizer (one
bucket with the loss), and every rank ends the step with the same state.

Steps run at the caller's precision: ``cli/scan.py`` runs them under
``device.precision_scope("default")``, where cuBLAS and cuDNN may use TF32
(the card's analogue of the TPU's single-pass f32); the card-vs-CPU checks
use ``"highest"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.distributed import collectives
from tpu_ac_torch.models.resnet_cifar import (
    CifarResNet,
    CifarResNetConfig,
    init_cifar_resnet,
    run_bound,
)
from tpu_ac_torch.ops.distances import knn_ip, knn_ip_sharded
from tpu_ac_torch.ops.normalize import l2_normalize
from tpu_ac_torch.train.optim import (
    GradientTransformation,
    add_decayed_weights,
    apply_updates,
    chain,
    sgd,
)
from tpu_ac_torch.utils.checkpoint import tree_flatten, tree_unflatten

EPS = 1e-8


# --------------------------------------------------------------------------
# Losses (losses/losses.py)
# --------------------------------------------------------------------------

def simclr_loss(features: torch.Tensor, temperature: float) -> torch.Tensor:
    """SimCLR NT-Xent on [B, 2, dim] normalized features
    (losses/losses.py:124-165, SupContrast formulation).  Across ranks the
    anchors are this rank's and the contrast set is every rank's (the
    global batch in rank order); the mean is over this rank's anchors."""
    b, n, _dim = features.shape
    if n != 2:
        raise ValueError(f"simclr_loss wants [B, 2, dim], got {n} views")
    contrast = torch.cat([collectives.all_gather(features[:, 0]),
                          collectives.all_gather(features[:, 1])], dim=0)
    anchor = features[:, 0]
    logits = anchor @ contrast.T / temperature
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    # mask out self-contrast (anchor i vs contrast i, global rows)
    dev = features.device
    rows = collectives.process_index() * b + torch.arange(b, device=dev)
    cols = torch.arange(contrast.shape[0] // 2, device=dev)
    eye = (rows[:, None] == cols[None, :]).to(features.dtype)
    zeros = torch.zeros_like(eye)
    logits_mask = 1.0 - torch.cat([eye, zeros], dim=1)
    pos_mask = torch.cat([zeros, eye], dim=1)
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True))
    return -torch.mean(torch.sum(pos_mask * log_prob, dim=1) /
                       torch.sum(pos_mask, dim=1))


def entropy(probs: torch.Tensor) -> torch.Tensor:
    """Entropy of a probability vector/batch (losses/losses.py:67-86)."""
    x = torch.clamp(probs, min=EPS)
    b = x * torch.log(x)
    if b.ndim == 2:
        return -torch.mean(torch.sum(b, dim=1))
    return -torch.sum(b)


def scan_loss(anchor_logits: torch.Tensor, neighbor_logits: torch.Tensor,
              entropy_weight: float = 2.0
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SCAN loss (losses/losses.py:89-121): BCE(dot of softmax pair, 1)
    minus weighted batch-entropy.  Returns (total, consistency, entropy).

    [B, C] logits give scalars; [H, B, C] (every head at once, one set of
    launches for all heads) give [H] vectors, each head's the same
    arithmetic as alone."""
    a = torch.softmax(anchor_logits, dim=-1)
    pos = torch.softmax(neighbor_logits, dim=-1)
    similarity = torch.sum(a * pos, dim=-1)
    consistency = -torch.mean(torch.log(torch.clamp(similarity, min=EPS)),
                              dim=-1)
    # the entropy of the global batch's mean prediction
    x = torch.clamp(collectives.global_mean(a, dim=-2), min=EPS)
    ent = -torch.sum(x * torch.log(x), dim=-1)
    return consistency - entropy_weight * ent, consistency, ent


def confidence_based_ce(weak_logits: torch.Tensor,
                        strong_logits: torch.Tensor,
                        threshold: float = 0.99,
                        apply_class_balancing: bool = True) -> torch.Tensor:
    """Self-labeling loss (losses/losses.py:25-64): pseudo-labels from
    confident weak-augmentation predictions, CE on strong augmentations,
    optional inverse-frequency class weights.  Masked arithmetic in place
    of the reference's boolean indexing, as ``tpu_ac`` has it (no
    data-dependent shape, so no host round trip on the card).  Across
    ranks the confident count, the class counts and the weights' sum are
    the global batch's, and each rank's loss is its share of the global
    sum over the global weights' mean over ranks, so that the global loss
    is the ranks' mean."""
    weak_logits = weak_logits.detach()
    probs = torch.softmax(weak_logits, dim=1)
    max_prob = torch.amax(probs, dim=1)
    target = torch.argmax(probs, dim=1)
    mask = (max_prob > threshold).to(weak_logits.dtype)
    n = collectives.all_reduce_sum(torch.sum(mask))
    c = weak_logits.shape[1]

    onehot = F.one_hot(target, c).to(weak_logits.dtype)
    if apply_class_balancing:
        counts = collectives.all_reduce_sum(
            torch.sum(onehot * mask[:, None], dim=0))  # [c]
        freq = torch.where(counts > 0, n / torch.clamp(counts, min=1.0),
                           torch.ones_like(counts))
        sample_w = freq[target]
    else:
        sample_w = torch.ones_like(max_prob)

    logp = torch.log_softmax(strong_logits, dim=1)
    per_sample = -torch.sum(onehot * logp, dim=1) * sample_w * mask
    # torch cross_entropy(weight=...) 'mean' divides by the sum of weights
    denom = torch.clamp(collectives.all_reduce_sum(
        torch.sum(sample_w * mask)), min=EPS)
    w = collectives.process_count()
    if w > 1:
        denom = denom / w
    return torch.sum(per_sample) / denom


# --------------------------------------------------------------------------
# Models (models/models.py)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SCANModelConfig:
    backbone: CifarResNetConfig = CifarResNetConfig()
    feature_dim: int = 128   # contrastive head output
    n_clusters: int = 10
    n_heads: int = 1
    head: str = "mlp"        # "mlp" | "linear" (models.py:18-26)


class ContrastiveModel(CifarResNet):
    """backbone -> head -> L2-normalized embedding (models.py:10-31):
    ``forward(images) -> (embedding [B, feature_dim], features)``."""

    def __init__(self, cfg: SCANModelConfig, head: str):
        super().__init__(cfg.backbone)
        d = cfg.backbone.feature_dim
        if head == "mlp":
            self.contrastive_head = nn.Sequential(
                nn.Linear(d, d), nn.ReLU(), nn.Linear(d, cfg.feature_dim))
        else:
            self.contrastive_head = nn.Linear(d, cfg.feature_dim)

    def forward(self, images: torch.Tensor):
        feats = self.features(images)
        return l2_normalize(self.contrastive_head(feats), dim=1), feats


class ClusteringModel(CifarResNet):
    """backbone -> n linear heads (models.py:34-62): ``forward(images) ->
    (logits [n_heads, B, n_clusters], features)``."""

    def __init__(self, cfg: SCANModelConfig):
        super().__init__(cfg.backbone)
        d = cfg.backbone.feature_dim
        self.cluster_head = nn.ModuleList(
            nn.Linear(d, cfg.n_clusters) for _ in range(cfg.n_heads))

    def forward(self, images: torch.Tensor):
        feats = self.features(images)
        return torch.stack([h(feats) for h in self.cluster_head]), feats


@functools.lru_cache(maxsize=None)
def _contrastive_module(cfg: SCANModelConfig, head: str) -> ContrastiveModel:
    with torch.device("meta"):
        return ContrastiveModel(cfg, head)


@functools.lru_cache(maxsize=None)
def _clustering_module(cfg: SCANModelConfig) -> ClusteringModel:
    with torch.device("meta"):
        return ClusteringModel(cfg)


def _contrastive_for(params, cfg: SCANModelConfig) -> ContrastiveModel:
    # the head the params hold, as tpu_ac reads it from the keys
    head = "mlp" if "contrastive_head.0.weight" in params else "linear"
    return _contrastive_module(cfg, head)


def _on(arrays: dict[str, np.ndarray], dev: torch.device
        ) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def init_contrastive_model(seed: int, cfg: SCANModelConfig,
                           device: str | torch.device = "cuda"):
    """ContrastiveModel (params, bn_state) on ``device``: the backbone
    from ``seed``, the head from ``default_rng(seed + 1)``, bit-identical
    to ``tpu_ac``'s (models.py:10-31)."""
    dev = resolve_device(device)
    params, bn_state = init_cifar_resnet(seed, cfg.backbone)
    rng = np.random.default_rng(seed + 1)
    d = cfg.backbone.feature_dim
    if cfg.head == "mlp":
        params["contrastive_head.0.weight"] = (
            rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
        params["contrastive_head.0.bias"] = np.zeros((d,), np.float32)
        params["contrastive_head.2.weight"] = (
            rng.standard_normal((cfg.feature_dim, d)) / np.sqrt(d)
        ).astype(np.float32)
        params["contrastive_head.2.bias"] = np.zeros((cfg.feature_dim,),
                                                     np.float32)
    else:
        params["contrastive_head.weight"] = (
            rng.standard_normal((cfg.feature_dim, d)) / np.sqrt(d)
        ).astype(np.float32)
        params["contrastive_head.bias"] = np.zeros((cfg.feature_dim,),
                                                   np.float32)
    return _on(params, dev), _on(bn_state, dev)


def contrastive_forward(params, bn_state, images: torch.Tensor,
                        cfg: SCANModelConfig, *, train: bool = False):
    """-> (embedding [B, feature_dim], features, new_bn_state)."""
    (emb, feats), new_state = run_bound(
        _contrastive_for(params, cfg), params, bn_state,
        lambda m: m(images), train=train)
    return emb, feats, new_state


def init_clustering_model(seed: int, cfg: SCANModelConfig,
                          device: str | torch.device = "cuda"):
    """ClusteringModel (params, bn_state) on ``device``: the backbone from
    ``seed``, the heads from ``default_rng(seed + 2)`` (models.py:34-51)."""
    dev = resolve_device(device)
    params, bn_state = init_cifar_resnet(seed, cfg.backbone)
    rng = np.random.default_rng(seed + 2)
    d = cfg.backbone.feature_dim
    for i in range(cfg.n_heads):
        params[f"cluster_head.{i}.weight"] = (
            rng.standard_normal((cfg.n_clusters, d)) / np.sqrt(d)
        ).astype(np.float32)
        params[f"cluster_head.{i}.bias"] = np.zeros((cfg.n_clusters,),
                                                    np.float32)
    return _on(params, dev), _on(bn_state, dev)


def clustering_forward(params, bn_state, images: torch.Tensor,
                       cfg: SCANModelConfig, *, train: bool = False):
    """-> (per-head logits [n_heads, B, C], features, new_bn_state)."""
    (logits, feats), new_state = run_bound(
        _clustering_module(cfg), params, bn_state, lambda m: m(images),
        train=train)
    return logits, feats, new_state


# --------------------------------------------------------------------------
# Memory bank (utils/memory.py)
# --------------------------------------------------------------------------

class MemoryBank:
    """Feature store + kNN monitors + neighbour mining (memory.py:6-88).

    The features live on ``device``; the targets on the host, as numpy.
    ``mesh``: an optional ``distributed.Mesh``: mining then row-shards the
    bank over it (``knn_ip_sharded``), the reference's
    faiss.index_cpu_to_all_gpus sharded IndexFlatIP (memory.py:52)."""

    def __init__(self, n: int, dim: int, num_classes: int,
                 temperature: float = 0.1, mesh=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.features = torch.zeros((n, dim), dtype=torch.float32,
                                    device=self.device)
        self.targets = np.zeros((n,), np.int64)
        self.ptr = 0
        self.num_classes = num_classes
        self.temperature = temperature
        self.mesh = mesh

    def update(self, features, targets: np.ndarray) -> None:
        # circular write: a batch crossing the end of the bank wraps
        b = len(features)
        n = len(self.features)
        idx = (self.ptr + np.arange(b)) % n
        self.features.index_copy_(
            0, torch.from_numpy(idx).to(self.device),
            torch.as_tensor(features).to(self.device, torch.float32))
        self.targets[idx] = np.asarray(targets)
        self.ptr = (self.ptr + b) % n

    def reset(self) -> None:
        self.ptr = 0

    def mine_nearest_neighbors(self, topk: int,
                               calculate_accuracy: bool = True):
        """IP search of the bank against itself (memory.py:46-65): returns
        [N, topk+1] indices (self included, as numpy) and the neighbours'
        label accuracy."""
        if self.mesh is not None:
            _sims, idx = knn_ip_sharded(self.features, self.features,
                                        topk + 1, self.mesh)
        else:
            _sims, idx = knn_ip(self.features, self.features, topk + 1)
        # int32, the dtype of tpu_ac's indices (and of its .npy artifact)
        idx = idx.to(torch.int32).cpu().numpy()
        if calculate_accuracy:
            neighbor_targets = self.targets[idx[:, 1:]]
            anchor_targets = self.targets[:, None]
            acc = float(np.mean(neighbor_targets == anchor_targets))
            return idx, acc
        return idx

    def weighted_knn(self, predictions_features, k: int = 200) -> np.ndarray:
        """Temperature-weighted kNN vote (memory.py:21-38)."""
        k = min(k, len(self.features))
        sims, idx = knn_ip(
            torch.as_tensor(predictions_features).to(self.device,
                                                     torch.float32),
            self.features, k)
        sims, idx = sims.cpu().numpy(), idx.cpu().numpy()
        weights = np.exp(sims / self.temperature)
        votes = np.zeros((len(sims), self.num_classes))
        for c in range(self.num_classes):
            votes[:, c] = np.sum(weights * (self.targets[idx] == c), axis=1)
        return votes.argmax(axis=1)


# --------------------------------------------------------------------------
# Train steps (utils/train_utils.py)
# --------------------------------------------------------------------------

class SCANTrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    bn_state: dict[str, torch.Tensor]
    opt_state: Any
    step: torch.Tensor  # int32 scalar


def _sgd(lr: float, momentum: float = 0.9, weight_decay: float = 1e-4,
         nesterov: bool = False) -> GradientTransformation:
    """optax.chain(add_decayed_weights(wd), sgd(lr, momentum))."""
    return chain(add_decayed_weights(weight_decay),
                 sgd(lr, momentum=momentum, nesterov=nesterov))


def init_train_state(params, bn_state, optimizer) -> SCANTrainState:
    dev = next(iter(params.values())).device
    return SCANTrainState(params=dict(params), bn_state=dict(bn_state),
                          opt_state=optimizer.init(dict(params)),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))


def scan_state_from_numpy(tree, optimizer: GradientTransformation,
                          device: str | torch.device = "cuda"
                          ) -> SCANTrainState:
    """A ``SCANTrainState`` of either package whose leaves are numpy
    arrays -> the port's state on ``device``.  ``optimizer`` gives the
    optimizer state's structure; its leaves are taken in
    ``jax.tree.flatten`` order, which optax's and the port's share."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    params = {k: t(v) for k, v in tree.params.items()}
    template = optimizer.init(params)
    opt_state = tree_unflatten(template,
                               [t(a) for a in tree_flatten(tree.opt_state)])
    return SCANTrainState(params=params,
                          bn_state={k: t(v) for k, v in tree.bn_state.items()},
                          opt_state=opt_state, step=t(tree.step))


def scan_state_to_numpy(state: SCANTrainState) -> SCANTrainState:
    """The port's state with every leaf as a numpy array (host copies)."""
    leaves = [x.detach().cpu().numpy() for x in tree_flatten(state)]
    return tree_unflatten(state, leaves)


def _grads(loss_fn, params: dict, trainable=None):
    """(loss, aux, grads) of ``loss_fn(leaves) -> (loss, aux)``; keys
    outside ``trainable`` (a predicate) get zero gradients without a
    backward through them."""
    names = [k for k in params if trainable is None or trainable(k)]
    leaves = dict(params)
    for k in names:
        leaves[k] = params[k].detach().requires_grad_(True)
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
    grads = {k: grads[k] if k in grads else torch.zeros_like(v)
             for k, v in params.items()}
    # across ranks: the gradients' and the loss's mean, in one bucket (""
    # names no parameter)
    reduced = collectives.all_reduce_dict({"": loss.detach(), **grads})
    return reduced[""], aux, {k: reduced[k] for k in grads}


def simclr_loss_and_grads(state: SCANTrainState, images_i, images_j,
                          cfg: SCANModelConfig, temperature: float = 0.1):
    """(loss, new_bn_state, grads) of simclr_train (train_utils.py:10-40):
    both views in one forward, NT-Xent on the pairs."""
    b = images_i.shape[0]
    both = torch.cat([images_i, images_j])

    def loss_fn(params):
        emb, _feats, new_bn = contrastive_forward(
            params, state.bn_state, both, cfg, train=True)
        features = torch.stack([emb[:b], emb[b:]], dim=1)
        return simclr_loss(features, temperature), new_bn

    return _grads(loss_fn, state.params)


def _is_head(k: str) -> bool:
    return k.startswith("cluster_head")


def scan_loss_and_grads(state: SCANTrainState, anchors, neighbors,
                        cfg: SCANModelConfig, entropy_weight: float = 2.0,
                        update_cluster_head_only: bool = False):
    """(loss, (new_bn_state, head_losses [n_heads]), grads) of scan_train
    (train_utils.py:43-96): two forwards, anchors then neighbours, the
    second from the BN statistics the first left (one fused batch would
    give other statistics and another loss); the loss summed over heads.
    Head-only mode (the reference's model.eval()): running-statistic BN,
    no statistic updates, zero gradients for the backbone."""
    bn_train = not update_cluster_head_only

    def loss_fn(params):
        a_logits, _, bn1 = clustering_forward(params, state.bn_state,
                                              anchors, cfg, train=bn_train)
        n_logits, _, bn2 = clustering_forward(params, bn1, neighbors, cfg,
                                              train=bn_train)
        totals = scan_loss(a_logits, n_logits, entropy_weight)[0]  # [H]
        return torch.sum(totals), (bn2, totals.detach())

    loss, (bn2, totals), grads = _grads(
        loss_fn, state.params, _is_head if update_cluster_head_only else None)
    # each head's loss over the global batch: the mean over ranks
    totals = collectives.all_reduce_dict({"": totals})[""]
    return loss, (bn2, totals), grads


def selflabel_loss_and_grads(state: SCANTrainState, images_weak,
                             images_strong, cfg: SCANModelConfig,
                             threshold: float = 0.99,
                             apply_class_balancing: bool = True):
    """(loss, new_bn_state, grads) of selflabel_train (train_utils.py:
    99-128) on the single cluster head.  Both passes run BN in train
    mode, as the reference's model.train() does: the weak pass (no
    gradient) advances the running statistics, then the strong pass
    advances them again."""
    with torch.no_grad():
        weak_logits, _, bn1 = clustering_forward(
            state.params, state.bn_state, images_weak, cfg, train=True)

    def loss_fn(params):
        strong_logits, _, new_bn = clustering_forward(
            params, bn1, images_strong, cfg, train=True)
        return confidence_based_ce(weak_logits[0], strong_logits[0],
                                   threshold, apply_class_balancing), new_bn

    return _grads(loss_fn, state.params)


def apply_gradients(state: SCANTrainState, grads, new_bn, optimizer,
                    frozen=None) -> SCANTrainState:
    """The optimizer's update of ``grads``, applied to the parameters
    except those ``frozen`` (a predicate) selects, whose UPDATES are zero
    (their optimizer state still advances, as in ``tpu_ac``)."""
    updates, opt_state = optimizer.update(grads, state.opt_state,
                                          state.params)
    if frozen is not None:
        updates = {k: u for k, u in updates.items() if not frozen(k)}
    params = apply_updates(state.params, updates)
    return SCANTrainState(params, new_bn, opt_state, state.step + 1)


def make_simclr_step(cfg: SCANModelConfig, optimizer,
                     temperature: float = 0.1):
    """simclr_train: (state, images_i, images_j) -> (state, loss)."""

    def step(state: SCANTrainState, images_i, images_j):
        loss, new_bn, grads = simclr_loss_and_grads(
            state, images_i, images_j, cfg, temperature)
        return apply_gradients(state, grads, new_bn, optimizer), loss

    return step


def make_scan_step(cfg: SCANModelConfig, optimizer,
                   entropy_weight: float = 2.0,
                   update_cluster_head_only: bool = False):
    """scan_train: (state, anchors, neighbors) -> (state, {"total",
    "head_losses"}).  ``update_cluster_head_only`` freezes the backbone:
    zero gradients AND zero updates, since under decoupled weight decay a
    zero gradient still moves a parameter."""

    def step(state: SCANTrainState, anchors, neighbors):
        loss, (new_bn, head_losses), grads = scan_loss_and_grads(
            state, anchors, neighbors, cfg, entropy_weight,
            update_cluster_head_only)
        frozen = ((lambda k: not _is_head(k)) if update_cluster_head_only
                  else None)
        return (apply_gradients(state, grads, new_bn, optimizer, frozen),
                {"total": loss, "head_losses": head_losses})

    return step


def make_selflabel_step(cfg: SCANModelConfig, optimizer,
                        threshold: float = 0.99,
                        apply_class_balancing: bool = True,
                        ema_momentum: float | None = None):
    """selflabel_train: (state, weak, strong[, ema_params]) -> (state,
    loss[, ema_params]), with the optional EMA of the params
    (utils/ema.py:6-18)."""

    def step(state: SCANTrainState, images_weak, images_strong,
             ema_params=None):
        loss, new_bn, grads = selflabel_loss_and_grads(
            state, images_weak, images_strong, cfg, threshold,
            apply_class_balancing)
        new_state = apply_gradients(state, grads, new_bn, optimizer)
        if ema_momentum is not None and ema_params is not None:
            names = list(ema_params)
            ema = torch._foreach_mul([ema_params[k] for k in names],
                                     ema_momentum)
            torch._foreach_add_(ema, torch._foreach_mul(
                [new_state.params[k] for k in names], 1 - ema_momentum))
            return new_state, loss, dict(zip(names, ema))
        return new_state, loss

    return step


def dp_shard_step(step_fn, mesh, n_batch_args: int):
    """The data-parallel step of ``tpu_ac`` (its ``dp_shard_step``).

    ``tpu_ac`` jits the unsharded step with the batch sharded over the
    mesh: its batch statistics, losses and gradient sums run over the
    WHOLE batch (sync-BN), so the sharded step equals the unsharded one.

    - In a ``torch.distributed`` group of the mesh's size (one process a
      rank: torchrun, ``cli/scan.py``'s spawn, or ranks that share a card
      over gloo), each rank runs the step on its own shard of the batch
      on its mesh position's device, and the step's collectives make it
      the global batch's (see the module's docstring).
    - Without a group, on a mesh whose positions are all one device (one
      card, or the CPU, repeated: ``distributed/mesh.py``), the step runs
      on the whole batch, after the same divisibility check.
    - A mesh of distinct cards without a group raises: it needs one
      process a card."""
    w = collectives.process_count()
    if w > 1:
        if mesh.size != w:
            raise ValueError(
                f"a {mesh.size}-way train_dp mesh in a group of {w} "
                "processes: they must be equal")
        dev = mesh.devices[collectives.process_index()]
    else:
        devices = mesh.distinct_devices
        if len(devices) > 1:
            raise RuntimeError(
                f"train_dp over {len(devices)} distinct devices runs one "
                "process a device: run under torchrun or through "
                "tpu_ac_torch.cli.scan (which starts the ranks), or join a "
                "group with distributed.multihost_init first")
        dev = devices[0]

    def step(state, *args):
        if w == 1:
            for a in args[:n_batch_args]:
                if a.shape[0] % mesh.size:
                    raise ValueError(
                        f"batch of {a.shape[0]} not divisible by the "
                        f"{mesh.size}-way data-parallel axis (train_dp)")
        args = (tuple(a.to(dev) for a in args[:n_batch_args])
                + args[n_batch_args:])
        return step_fn(state, *args)

    return step


def scan_evaluate_heads(head_losses) -> int:
    """Lowest-loss head selection (evaluate_utils.py:87-119)."""
    return int(np.argmin(np.asarray(head_losses)))


def _batches(images: np.ndarray, batch_size: int, dev: torch.device):
    for i in range(0, len(images), batch_size):
        yield i, torch.from_numpy(np.ascontiguousarray(
            images[i:i + batch_size])).to(dev)


@torch.no_grad()
def contrastive_evaluate(params, bn_state, images: np.ndarray,
                         targets: np.ndarray, bank: MemoryBank,
                         cfg: SCANModelConfig, batch_size: int = 256
                         ) -> float:
    """Weighted-kNN accuracy monitor on memory-bank features
    (utils/evaluate_utils.py:16-31 contrastive_evaluate)."""
    dev = next(iter(params.values())).device
    correct = 0
    for i, x in _batches(images, batch_size, dev):
        emb = contrastive_forward(params, bn_state, x, cfg)[0]
        pred = bank.weighted_knn(emb)
        correct += int(np.sum(pred == targets[i:i + batch_size]))
    return correct / len(images)


@torch.no_grad()
def get_prototypes(params, bn_state, images: np.ndarray,
                   cfg: SCANModelConfig, head: int = 0,
                   batch_size: int = 256) -> np.ndarray:
    """Most-confident sample index per cluster
    (Unsupervised-Classification-master/eval.py:96-128)."""
    dev = next(iter(params.values())).device
    all_probs = []
    for _i, x in _batches(images, batch_size, dev):
        logits = clustering_forward(params, bn_state, x, cfg)[0][head]
        all_probs.append(torch.softmax(logits, dim=1).cpu().numpy())
    probs = np.concatenate(all_probs)
    preds = probs.argmax(1)
    protos = np.full(cfg.n_clusters, -1, np.int64)
    for c in range(cfg.n_clusters):
        members = np.where(preds == c)[0]
        if len(members):
            protos[c] = members[np.argmax(probs[members, c])]
    return protos
