"""The port's DINO step over two gloo ranks on the CPU (a ViT of 2 blocks,
width 64, out_dim 256), each rank on its half of the batch, against one
process on the whole batch; the logger's sums over the ranks; the CLI in
two ranks, where only rank 0 writes.

Tolerances: the ranks' states are equal to each other bit for bit (the
gradients and the center's sum are all-reduced, then every rank runs the
same update).  Against the one-process step (the same f32 ops summed in
another order, and the gradient as the mean of two halves'): 1e-5
absolute on every leaf after two steps, except for the parameters whose
first gradient is below 1e-6, held to Adam's sign swing, 2 lr a step
(tests/test_torch_dino_train.py); Adam's second moments to 1e-4 relative
(squares of the gradients).  The ranks' mean loss equals the whole
batch's within 1e-5 relative.

The ranks run in processes of their own with a per-test timeout
(tests/test_torch_multihost.py's _run_ranks, 150 s).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_multihost import _run_ranks
from tpu_ac_torch.models.vit import ViTConfig
from tpu_ac_torch.train import dino as td

VIT_KW = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, img_size=32)
CFG_KW = dict(out_dim=256, local_crops_number=2, global_size=32,
              local_size=16, head_hidden_dim=64, head_bottleneck_dim=32,
              epochs=2, steps_per_epoch=4)
LR, B, STEPS = 1e-3, 4, 2


_CHILD = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
coord, out = sys.argv[3], sys.argv[4]
from tpu_ac_torch.distributed import multihost_init
from tpu_ac_torch.models.vit import ViTConfig
from tpu_ac_torch.train import dino as td
from tpu_ac_torch.utils import MetricLogger

multihost_init(coordinator_address=coord, num_processes=world,
               process_id=rank)
spec = json.load(open(out + "/spec.json"))
vit, cfg = ViTConfig(**spec["vit"]), td.DINOConfig(**spec["cfg"])
crops = np.load(out + "/crops.npz")
state = td.init_dino_state(0, vit, cfg, device="cpu")
step = td.make_dino_train_step(vit, cfg)
res = {}
for i in range(spec["steps"]):
    state, m = step(state, torch.from_numpy(crops[f"g{i}_{rank}"]),
                    torch.from_numpy(crops[f"l{i}_{rank}"]), lr=spec["lr"],
                    wd=0.04, teacher_momentum=0.996, teacher_temp=0.04,
                    freeze_last=False)
    res[f"loss{i}"] = m["loss"].numpy()
flat = td.dino_state_to_numpy(state)
for part in ("student", "teacher"):
    res.update({f"{part}/{k}": v for k, v in getattr(flat, part).items()})
res.update({f"mu/{k}": v for k, v in flat.opt_state.mu.items()})
res.update({f"nu/{k}": v for k, v in flat.opt_state.nu.items()})
res["count"], res["center"], res["step"] = (
    flat.opt_state.count, flat.center, flat.step)

# the logger: rank r logs r + 1 values of 10 r + j
logger = MetricLogger()
for j in range(rank + 1):
    logger.update(loss=10.0 * rank + j)
logger.synchronize_between_processes()
res["log_count"] = np.array(logger.loss.count)
res["log_total"] = np.array(logger.loss.total)
np.savez(f"{out}/rank{rank}.npz", **res)

# the CLI in this group; every checkpoint write is recorded with its rank
from tpu_ac_torch.cli import dino as tcli
saves = []
real_save = tcli.save_checkpoint
def save(*a, **kw):
    saves.append(a[1])
    return real_save(*a, **kw)
tcli.save_checkpoint = save
tcli.main(spec["cli"])
json.dump(saves, open(f"{out}/saves{rank}.json", "w"))
dist.destroy_process_group()
"""


def _shard(x: np.ndarray, views: int, r: int, w: int) -> np.ndarray:
    """Rank r's share of a crop-major batch [views * B, ...]."""
    v = x.reshape(views, -1, *x.shape[1:])
    b = v.shape[1] // w
    return v[:, r * b:(r + 1) * b].reshape(-1, *x.shape[1:])


def _batches():
    rng = np.random.default_rng(12)
    return [(rng.standard_normal((2 * B, 3, 32, 32)).astype(np.float32),
             rng.standard_normal((2 * B, 3, 16, 16)).astype(np.float32))
            for _ in range(STEPS)]


def _folder(root) -> str:
    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(d / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_dino")
    crops = {}
    for i, (g, l) in enumerate(_batches()):
        for r in range(2):
            crops[f"g{i}_{r}"] = _shard(g, 2, r, 2)
            crops[f"l{i}_{r}"] = _shard(l, 2, r, 2)
    np.savez(out / "crops.npz", **crops)
    cli_out = out / "cli"
    spec = {"vit": VIT_KW, "cfg": CFG_KW, "lr": LR, "steps": STEPS,
            "cli": ["--arch", "vit_tiny", "--patch_size", "16",
                    "--data_path", _folder(out / "data"),
                    "--output_dir", str(cli_out), "--global_size", "32",
                    "--local_size", "16", "--local_crops_number", "2",
                    "--out_dim", "64", "--batch_size_per_gpu", "2",
                    "--epochs", "2", "--max_steps_per_epoch", "1",
                    "--warmup_epochs", "0", "--saveckp_freq", "0",
                    "--use_fp16", "false", "--num_workers", "0",
                    "--device", "cpu"]}
    with open(out / "spec.json", "w") as f:
        json.dump(spec, f)
    _run_ranks(_CHILD, 2, out)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def whole():
    """One process on the whole batch: the state after the steps, the
    losses, and the first step's gradients (for Adam's sign swing)."""
    vit, cfg = ViTConfig(**VIT_KW), td.DINOConfig(**CFG_KW)
    state = td.init_dino_state(0, vit, cfg, device="cpu")
    model = td.build_dino_model(vit, cfg)
    g0, l0 = (torch.from_numpy(x) for x in _batches()[0])
    grads = td.dino_loss_and_grads(model, state, g0, l0, 0.04, cfg)[2]
    step = td.make_dino_train_step(vit, cfg)
    losses = []
    for g, l in _batches():
        state, m = step(state, torch.from_numpy(g), torch.from_numpy(l),
                        lr=LR, wd=0.04, teacher_momentum=0.996,
                        teacher_temp=0.04, freeze_last=False)
        losses.append(float(m["loss"]))
    flat = td.dino_state_to_numpy(state)
    leaves = {}
    for part in ("student", "teacher"):
        leaves.update({f"{part}/{k}": v
                       for k, v in getattr(flat, part).items()})
    leaves.update({f"mu/{k}": v for k, v in flat.opt_state.mu.items()})
    leaves.update({f"nu/{k}": v for k, v in flat.opt_state.nu.items()})
    leaves.update(count=flat.opt_state.count, center=flat.center,
                  step=flat.step)
    return leaves, losses, {k: g.numpy() for k, g in grads.items()}


def test_ranks_end_bit_equal(ranks):
    _, (r0, r1) = ranks
    for k in r0:
        if k.startswith(("student/", "teacher/", "mu/", "nu/")) or k in (
                "count", "center", "step"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_two_ranks_equal_one_process(ranks, whole):
    _, (r0, r1) = ranks
    want, losses, grads = whole
    for i, loss in enumerate(losses):
        got = (float(r0[f"loss{i}"]) + float(r1[f"loss{i}"])) / 2
        assert got == pytest.approx(loss, rel=1e-5)
    for k, b in want.items():
        a = r0[k].copy()
        b = b.copy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        part, _, name = k.partition("/")
        if part in ("student", "teacher"):
            near_eps = np.abs(grads[name]) < 1e-6
            np.testing.assert_allclose(a[near_eps], b[near_eps], rtol=0,
                                       atol=2 * LR * STEPS, err_msg=k)
            a[near_eps] = b[near_eps] = 0
        if part == "nu":
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)


def test_logger_sums_over_ranks(ranks):
    """count and total summed over the ranks (tpu_ac's SmoothedValue
    .synchronize_between_processes): rank 0 logged 0; rank 1 10 and 11."""
    _, rs = ranks
    for r in rs:
        assert int(r["log_count"]) == 3
        assert float(r["log_total"]) == 21.0


def test_cli_only_rank0_writes(ranks):
    """The CLI joins the caller's group; rank 0 alone saves the two
    epochs' checkpoints and writes log.txt (one line an epoch)."""
    out, _ = ranks
    with open(out / "saves0.json") as f:
        assert json.load(f) == ["checkpoint", "checkpoint"]
    with open(out / "saves1.json") as f:
        assert json.load(f) == []
    with open(out / "cli" / "log.txt") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in rows)
