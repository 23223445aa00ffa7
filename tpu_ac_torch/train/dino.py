"""DINO self-supervised training (port of ``tpu_ac.train.dino``;
dino-main/main_dino.py:132-416).

Student and teacher ViT + projection head, the teacher an EMA of the
student; multi-crop (the 2 global crops through the teacher, all crops
through the student, one backbone pass per resolution and the head on the
concatenation); DINOLoss (a centred, sharpened teacher softmax against the
student's log-softmax over cross-view pairs); cosine lr/wd/momentum
schedules; per-parameter gradient clipping; the last layer frozen for the
first epochs; AdamW with decoupled, schedule-driven weight decay.

The state is ``tpu_ac``'s: flat dicts of f32 tensors keyed like the torch
state_dict (``backbone.*``, ``head.*``), Adam's ``count``/``mu``/``nu``
(optax's ``ScaleByAdamState``), the center and the step.  The update is
written by hand on ``torch._foreach_*`` lists, not ``torch.optim.AdamW``,
to keep optax's semantics: one shared ``count`` for the bias correction,
``eps`` outside the square root, and moments that advance (with zero
gradients) for the frozen last layer, whose parameters stay.  AdamW would
skip a parameter whose grad is None and count steps per parameter, so it
would train another model in the frozen epoch.

Mixed precision (``compute_dtype=torch.bfloat16``, ``--use_fp16``) is
``tpu_ac``'s: a bf16 copy of every parameter and of the crops, the whole
forward and backward in bf16, the head outputs cast to f32; gradients
reach the f32 masters through the casts.  ``torch.autocast`` is not used:
it keeps LayerNorm and softmax in f32 and so would train another model.

The step is functional: it returns a new state and leaves its argument
as it was.  The module (``DINOModel``) lives on the meta device and holds
no weights: each forward binds the state's tensors to it
(``DINOModel.bound``), for the backward too, which is where ``remat``
recomputes its blocks.  ``tpu_ac``'s ``scan_blocks`` (a ``lax.scan`` over
the blocks, which cuts XLA's compile time) has no meaning in eager torch
and is dropped.

Across processes (a ``torch.distributed`` group, ``distributed.
multihost_init``) each rank holds its shard of the batch, and the step is
the reference's over the global batch (main_dino.py:406-416, DDP plus the
center's all_reduce): the gradients are averaged over the ranks before the
clip, and the center's batch mean is the all-reduced sum of the teacher's
outputs over the global count.  Each rank's loss is its shard's mean, as
the reference logs it; every rank ends the step with the same state, bit
for bit.  ``tpu_ac``'s multi-process CLI trains one replica a process
instead (ROADMAP Queue 3).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_ac_torch.data.mvtec import normalize_on_device
from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.distributed import collectives
from tpu_ac_torch.models.dino_head import DINOHead, init_dino_head_params
from tpu_ac_torch.models.vit import ViT, ViTConfig, init_vit_params
from tpu_ac_torch.train.optim import AdamState, scale_by_adam

Params = Mapping[str, torch.Tensor]

@dataclasses.dataclass(frozen=True)
class DINOConfig:
    """Mirrors the main_dino.py argparse defaults (main_dino.py:41-129)."""

    out_dim: int = 65536
    local_crops_number: int = 8
    global_size: int = 224
    local_size: int = 96
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.04
    warmup_teacher_temp_epochs: int = 0
    student_temp: float = 0.1
    center_momentum: float = 0.9
    momentum_teacher: float = 0.996
    use_bn_in_head: bool = False
    norm_last_layer: bool = True
    epochs: int = 100
    steps_per_epoch: int = 1000
    lr: float = 0.0005  # scaled by batch/256 by the caller, main_dino.py:226
    warmup_epochs: int = 10
    min_lr: float = 1e-6
    weight_decay: float = 0.04
    weight_decay_end: float = 0.4
    clip_grad: float = 3.0
    freeze_last_layer: int = 1
    head_hidden_dim: int = 2048
    head_bottleneck_dim: int = 256
    head_nlayers: int = 3
    remat: bool | str = False  # checkpoint each block; 'dots' keeps matmuls

    @property
    def ncrops(self) -> int:
        return 2 + self.local_crops_number

    @property
    def total_steps(self) -> int:
        return self.epochs * self.steps_per_epoch


def cosine_scheduler(base_value: float, final_value: float, total_steps: int,
                     warmup_steps: int = 0,
                     start_warmup_value: float = 0.0) -> np.ndarray:
    """dino-main/utils.py:187-198 as a per-step table."""
    warmup_steps = min(warmup_steps, total_steps)
    warmup = np.linspace(start_warmup_value, base_value, warmup_steps)
    iters = np.arange(total_steps - warmup_steps)
    cos = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / max(1, len(iters))))
    return np.concatenate([warmup, cos]).astype(np.float32)


def make_schedules(cfg: DINOConfig, batch_size_global: int
                   ) -> dict[str, np.ndarray]:
    """Per-step lr/wd/momentum tables, per-epoch teacher temperature
    (main_dino.py:238-251, 371-377)."""
    scaled_lr = cfg.lr * batch_size_global / 256.0
    lr = cosine_scheduler(scaled_lr, cfg.min_lr, cfg.total_steps,
                          cfg.warmup_epochs * cfg.steps_per_epoch)
    wd = cosine_scheduler(cfg.weight_decay, cfg.weight_decay_end,
                          cfg.total_steps)
    mom = cosine_scheduler(cfg.momentum_teacher, 1.0, cfg.total_steps)
    temp = np.concatenate([
        np.linspace(cfg.warmup_teacher_temp, cfg.teacher_temp,
                    cfg.warmup_teacher_temp_epochs),
        np.full(max(0, cfg.epochs - cfg.warmup_teacher_temp_epochs),
                cfg.teacher_temp),
    ]).astype(np.float32)
    return {"lr": lr, "wd": wd, "momentum": mom, "teacher_temp": temp}


def make_step_schedule_tables(cfg: DINOConfig,
                              schedules: Mapping[str, np.ndarray],
                              device: str | torch.device = "cuda"
                              ) -> dict[str, torch.Tensor]:
    """The five per-STEP tables a ``resident_schedules`` step indexes on
    the device at its clamped step counter: lr, wd, momentum, the epoch's
    teacher temperature and the freeze-last-layer flag
    (main_dino.py:334-336).  No host-to-device scalar copy per step."""
    dev = resolve_device(device)
    t = cfg.total_steps
    epoch_of = np.minimum(np.arange(t) // cfg.steps_per_epoch,
                          cfg.epochs - 1)
    temp = np.asarray(schedules["teacher_temp"], np.float32)
    tables = {
        "lr": np.asarray(schedules["lr"], np.float32),
        "wd": np.asarray(schedules["wd"], np.float32),
        "momentum": np.asarray(schedules["momentum"], np.float32),
        "teacher_temp": temp[np.minimum(epoch_of, len(temp) - 1)],
        "freeze_last": epoch_of < cfg.freeze_last_layer,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in tables.items()}


class DINOTrainState(NamedTuple):
    student: dict[str, torch.Tensor]  # backbone.* + head.* flat params
    teacher: dict[str, torch.Tensor]
    opt_state: AdamState
    center: torch.Tensor  # [1, out_dim]
    step: torch.Tensor  # int32 scalar


class DINOModel(nn.Module):
    """MultiCropWrapper (dino-main/utils.py:594-629): the backbone once per
    resolution, the head on the concatenation.  Built on the meta device
    by ``build_dino_model``; ``bound(params)`` binds real tensors."""

    def __init__(self, vit_cfg: ViTConfig, cfg: DINOConfig):
        super().__init__()
        self.backbone = ViT(vit_cfg)
        self.head = DINOHead(vit_cfg.embed_dim, cfg.out_dim,
                             nlayers=cfg.head_nlayers,
                             hidden_dim=cfg.head_hidden_dim,
                             bottleneck_dim=cfg.head_bottleneck_dim)
        self._slots = {f"{mname}.{pname}" if mname else pname: (m, pname)
                       for mname, m in self.named_modules()
                       for pname in m._parameters}

    @contextlib.contextmanager
    def bound(self, params: Params):
        """Run the block with ``params`` (name -> tensor, every parameter)
        in place of the module's own.  Unlike ``torch.func.
        functional_call``, the binding lasts for the whole block, so the
        backward's recompute under ``remat`` sees the same tensors."""
        if params.keys() != self._slots.keys():
            raise KeyError(
                f"params do not match the model: missing "
                f"{sorted(self._slots.keys() - params.keys())[:3]}, "
                f"unexpected {sorted(params.keys() - self._slots.keys())[:3]}")
        saved = []
        try:
            for name, t in params.items():
                m, attr = self._slots[name]
                saved.append((m, attr, m._parameters[attr]))
                m._parameters[attr] = t
            yield self
        finally:
            for m, attr, orig in reversed(saved):
                m._parameters[attr] = orig

    def forward(self, global_crops: torch.Tensor,
                local_crops: torch.Tensor | None = None,
                remat: bool | str = False) -> torch.Tensor:
        """-> [(2 + L) * B, out_dim]."""
        feats = [self.backbone.forward_cls(global_crops, remat)]
        if local_crops is not None:
            feats.append(self.backbone.forward_cls(local_crops, remat))
        return self.head(torch.cat(feats))


def build_dino_model(vit_cfg: ViTConfig, cfg: DINOConfig) -> DINOModel:
    with torch.device("meta"):
        return DINOModel(vit_cfg, cfg)


def init_dino_state(seed: int, vit_cfg: ViTConfig, cfg: DINOConfig,
                    device: str | torch.device = "cuda") -> DINOTrainState:
    """The seeded init of ``tpu_ac.train.dino.init_dino_state``,
    bit-identical: the backbone from ``seed``, the head from ``seed +
    1``, the teacher a copy of the student, Adam's moments zero."""
    dev = resolve_device(device)
    backbone = init_vit_params(seed, vit_cfg)
    head = init_dino_head_params(seed + 1, vit_cfg.embed_dim, cfg.out_dim,
                                 nlayers=cfg.head_nlayers,
                                 hidden_dim=cfg.head_hidden_dim,
                                 bottleneck_dim=cfg.head_bottleneck_dim)
    arrays = ({f"backbone.{k}": v for k, v in backbone.items()} |
              {f"head.{k}": v for k, v in head.items()})
    student = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    return DINOTrainState(
        student=student,
        teacher={k: v.clone() for k, v in student.items()},
        opt_state=AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(v) for k, v in student.items()},
            nu={k: torch.zeros_like(v) for k, v in student.items()}),
        center=torch.zeros((1, cfg.out_dim), dtype=torch.float32,
                           device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def dino_state_from_numpy(tree, device: str | torch.device = "cuda"
                          ) -> DINOTrainState:
    """A ``DINOTrainState`` of either package whose leaves are numpy
    arrays (``student``, ``teacher``, ``opt_state.count/mu/nu``,
    ``center``, ``step``) -> the port's state on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    def d(m):
        return {k: t(v) for k, v in m.items()}

    opt = tree.opt_state
    return DINOTrainState(
        student=d(tree.student), teacher=d(tree.teacher),
        opt_state=AdamState(count=t(opt.count), mu=d(opt.mu), nu=d(opt.nu)),
        center=t(tree.center), step=t(tree.step))


def dino_state_to_numpy(state: DINOTrainState) -> DINOTrainState:
    """The port's state with every leaf as a numpy array (host copies)."""
    def a(x):
        return x.detach().cpu().numpy()

    def d(m):
        return {k: a(v) for k, v in m.items()}

    opt = state.opt_state
    return DINOTrainState(
        student=d(state.student), teacher=d(state.teacher),
        opt_state=AdamState(count=a(opt.count), mu=d(opt.mu), nu=d(opt.nu)),
        center=a(state.center), step=a(state.step))


def _no_wd_mask(params: Params) -> dict[str, bool]:
    """True where weight decay applies: not 1-D params, not biases
    (dino-main/utils.py:632-643)."""
    return {k: (v.ndim > 1 and not k.endswith(".bias"))
            for k, v in params.items()}


def dino_loss(student_out: torch.Tensor, teacher_out: torch.Tensor,
              center: torch.Tensor, ncrops: int,
              teacher_temp: torch.Tensor | float,
              student_temp: float = 0.1) -> torch.Tensor:
    """Cross-view CE of the sharpened teacher against the student
    (main_dino.py:380-404).  student_out [ncrops*B, D], teacher_out
    [2*B, D]; no gradient flows into the teacher side."""
    s = (student_out / student_temp).reshape(ncrops, -1,
                                             student_out.shape[-1])
    t = torch.softmax((teacher_out - center) / teacher_temp, dim=-1)
    t = t.detach().reshape(2, -1, teacher_out.shape[-1])
    logp = torch.log_softmax(s, dim=-1)
    total, n_terms = 0.0, 0
    for iq in range(2):
        for v in range(ncrops):
            if v == iq:
                continue
            total = total + torch.mean(torch.sum(-t[iq] * logp[v], dim=-1))
            n_terms += 1
    return total / n_terms


def _cast(t: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def dino_loss_and_grads(model: DINOModel, state: DINOTrainState,
                        global_crops: torch.Tensor,
                        local_crops: torch.Tensor | None,
                        teacher_temp: torch.Tensor | float,
                        cfg: DINOConfig,
                        compute_dtype: torch.dtype | None = None):
    """(loss, teacher_out [2B, out_dim] f32, grads {name: f32 tensor}) of
    the student's parameters, before clipping.  uint8 crops are
    normalized here, on their device."""
    if global_crops.dtype == torch.uint8:
        global_crops = normalize_on_device(global_crops)
    if local_crops is not None and local_crops.dtype == torch.uint8:
        local_crops = normalize_on_device(local_crops)
    use_local = cfg.local_crops_number > 0
    ncrops = cfg.ncrops if use_local else 2
    g = _cast(global_crops, compute_dtype)
    l = (_cast(local_crops, compute_dtype)
         if use_local and local_crops is not None else None)
    teacher = {k: _cast(v, compute_dtype) for k, v in state.teacher.items()}
    with torch.no_grad(), model.bound(teacher):
        t_out = model(g).float()
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in state.student.items()}
    with torch.enable_grad():
        student = {k: _cast(v, compute_dtype) for k, v in leaves.items()}
        with model.bound(student):
            s_out = model(g, l, remat=cfg.remat).float()
            loss = dino_loss(s_out, t_out, state.center, ncrops,
                             teacher_temp, cfg.student_temp)
            grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), t_out, dict(zip(leaves, grads))


def dino_update(state: DINOTrainState, grads: Params,
                t_out: torch.Tensor, lr: torch.Tensor, wd: torch.Tensor,
                teacher_momentum: torch.Tensor, freeze_last: torch.Tensor,
                cfg: DINOConfig) -> DINOTrainState:
    """Clip, freeze, Adam, decoupled weight decay, teacher and center EMAs
    (``tpu_ac``'s ``train_step`` after its ``value_and_grad``), in f32 on
    ``_foreach`` lists.  Schedule values are 0-d tensors on the state's
    device; ``freeze_last`` is bool."""
    names = list(state.student)
    params = [state.student[k] for k in names]
    g = [grads[k] for k in names]
    if cfg.clip_grad:
        # per-parameter norm clipping (dino-main/utils.py:132-142)
        norms = torch.stack(torch._foreach_norm(g))
        coef = torch.clamp(cfg.clip_grad / (norms + 1e-6), max=1.0)
        g = torch._foreach_mul(g, list(coef.unbind()))
    # cancel_gradients_last_layer (utils.py:144-149): a zero gradient, and
    # (below) the parameter itself kept
    frozen = [k.startswith("head.last_layer") for k in names]
    g = [torch.where(freeze_last, torch.zeros_like(gi), gi) if f else gi
         for gi, f in zip(g, frozen)]

    opt = state.opt_state
    u, mu, nu, count = scale_by_adam(g, [opt.mu[k] for k in names],
                                     [opt.nu[k] for k in names], opt.count)

    wd_mask = _no_wd_mask(state.student)
    decayed = [i for i, k in enumerate(names) if wd_mask[k]]
    if decayed:  # u + wd * p, in place on u's fresh tensors
        torch._foreach_add_([u[i] for i in decayed],
                            torch._foreach_mul([params[i] for i in decayed],
                                               wd))
    new = torch._foreach_sub(params, torch._foreach_mul(u, lr))
    new = [torch.where(freeze_last, p, q) if f else q
           for p, q, f in zip(params, new, frozen)]
    student = dict(zip(names, new))
    # norm_last_layer: weight_g stays at its value (vision_transformer.py
    # :278-280)
    if cfg.norm_last_layer and "head.last_layer.weight_g" in student:
        student["head.last_layer.weight_g"] = (
            state.student["head.last_layer.weight_g"])

    t_names = list(state.teacher)
    teacher = torch._foreach_mul([state.teacher[k] for k in t_names],
                                 teacher_momentum)
    torch._foreach_add_(teacher, torch._foreach_mul(
        [student[k] for k in t_names], 1.0 - teacher_momentum))

    # center EMA over the teacher's outputs of the (global) batch
    batch_center = collectives.global_mean(t_out, dim=0)[None]
    center = (state.center * cfg.center_momentum +
              batch_center * (1.0 - cfg.center_momentum))
    return DINOTrainState(
        student=student, teacher=dict(zip(t_names, teacher)),
        opt_state=AdamState(count=count, mu=dict(zip(names, mu)),
                            nu=dict(zip(names, nu))),
        center=center, step=state.step + 1)


def make_dino_train_step(vit_cfg: ViTConfig, cfg: DINOConfig,
                         compute_dtype: torch.dtype | None = None,
                         resident_schedules: bool = False):
    """The train step.

    Signature: (state, global_crops [2B, 3, Hg, Wg], local_crops [L*B, 3,
    Hl, Wl] or None, lr, wd, teacher_momentum, teacher_temp, freeze_last)
    -> (state, metrics), the schedule values as host scalars (the
    reference indexes per-iteration tables on the host,
    main_dino.py:309-312).  Crop order is crop-major: all first globals,
    then all second globals, then the locals slot by slot.

    With ``resident_schedules=True`` it is (state, global_crops,
    local_crops, tables), ``tables`` from ``make_step_schedule_tables``,
    indexed on the device at ``min(state.step, total_steps - 1)``, the
    reference's ``it`` clamp (main_dino.py:309).  Both paths run the same
    update on the same 0-d tensors, so their numbers are equal.

    metrics: {"loss", "lr", "wd"}, 0-d tensors on the state's device.
    """
    model = build_dino_model(vit_cfg, cfg)

    def train_step(state: DINOTrainState, global_crops, local_crops,
                   lr, wd, teacher_momentum, teacher_temp, freeze_last):
        dev = state.step.device

        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=dev)

        lr, wd, teacher_momentum, teacher_temp = (
            f32(lr), f32(wd), f32(teacher_momentum), f32(teacher_temp))
        freeze_last = torch.as_tensor(freeze_last, dtype=torch.bool,
                                      device=dev)
        loss, t_out, grads = dino_loss_and_grads(
            model, state, global_crops, local_crops, teacher_temp, cfg,
            compute_dtype)
        # DDP's average over the ranks, before the clip (one bucket)
        grads = collectives.all_reduce_dict(grads, "mean")
        new_state = dino_update(state, grads, t_out, lr, wd,
                                teacher_momentum, freeze_last, cfg)
        return new_state, {"loss": loss, "lr": lr, "wd": wd}

    if not resident_schedules:
        return train_step

    def train_step_resident(state: DINOTrainState, global_crops,
                            local_crops, tables):
        # index_select keeps the index on the device (indexing with a 0-d
        # tensor would read it back to the host)
        it = torch.clamp(state.step, max=cfg.total_steps - 1).long()

        def at(name):
            return tables[name].index_select(0, it.reshape(1))[0]

        return train_step(state, global_crops, local_crops,
                          lr=at("lr"), wd=at("wd"),
                          teacher_momentum=at("momentum"),
                          teacher_temp=at("teacher_temp"),
                          freeze_last=at("freeze_last"))

    return train_step_resident


def make_dino_multi_step(vit_cfg: ViTConfig, cfg: DINOConfig, k: int,
                         compute_dtype: torch.dtype | None = None):
    """k resident-schedule steps queued back to back: (state,
    global_stack [k, 2B, ...], local_stack [k, L*B, ...] or None, tables)
    -> (state, metrics with each value stacked [k]).

    ``tpu_ac`` fuses the k steps into one ``lax.scan`` program to pay one
    dispatch per k steps on a remote-attached chip.  Eager torch queues
    the same kernels step after step either way, so the numbers equal k
    single steps; what remains of the lever is one metrics fetch per
    group.
    """
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    step = make_dino_train_step(vit_cfg, cfg, compute_dtype,
                                resident_schedules=True)

    def multi_step(state: DINOTrainState, global_stack, local_stack,
                   tables):
        ms = []
        for i in range(global_stack.shape[0]):
            state, m = step(state, global_stack[i],
                            None if local_stack is None else local_stack[i],
                            tables)
            ms.append(m)
        return state, {key: torch.stack([m[key] for m in ms])
                       for key in ms[0]}

    return multi_step
