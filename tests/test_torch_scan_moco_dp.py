"""The port's SCAN CLI options on the CPU: ``train_dp`` (the batches
trimmed to the dp multiple exactly as tpu_ac trims them, the step on the
whole batch on a virtual mesh, so the artifacts equal the run without
it), ``mine_dp`` (the bank sharded over Mesh(["cpu"] * dp): the same
neighbours), the ragged ``train_dp`` batch, and the ``moco`` stage on a
synthetic ImageFolder from a MoCo-v2-format checkpoint (its pretext model
equals tpu_ac's remap of the checkpoint, array for array, and restores
into the scan stage's template).  The arithmetic is the same ops on the same
data, so equality is the tolerance."""

import glob
import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ac.models.convert import moco_to_contrastive_params as j_remap
from tpu_ac_torch.cli import scan as tcli
from tpu_ac_torch.models.resnet_cifar import RESNET50_IMAGENET
from tpu_ac_torch.train import scan as ts
from tpu_ac_torch.utils import restore_checkpoint

EXP = ("train_db_name: synthetic\nnum_classes: 2\nsynthetic_per_class: 8\n"
       "image_size: 32\nnum_heads: 2\nnum_neighbors: 3\nbatch_size: 8\n"
       "epochs: 1\nfeature_dim: 16\nlr: 0.05\nnum_workers: 0\n")


def _cfg(root, exp):
    os.makedirs(root, exist_ok=True)
    env = os.path.join(root, "env.yml")
    with open(env, "w") as f:
        f.write(f"root_dir: {root}/out\n")
    path = os.path.join(root, "exp.yml")
    with open(path, "w") as f:
        f.write(exp)
    return env, path


def _run(stages, env, exp):
    for stage in stages:
        tcli.main([stage, "--config_env", env, "--config_exp", exp,
                   "--device", "cpu"])


def _arrays(root, db, stage):
    (path,) = glob.glob(os.path.join(root, "out", db, stage, "model-*"))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def plain_and_dp(tmp_path_factory):
    """simclr without and with train_dp: 4 and mine_dp: 4 (batch 8: no
    trim); every stage's step goes through the same dp_shard_step."""
    roots = {}
    for tag, extra in (("plain", ""), ("dp", "train_dp: 4\nmine_dp: 4\n")):
        root = str(tmp_path_factory.mktemp(tag))
        _run(("simclr",), *_cfg(root, EXP + extra))
        roots[tag] = root
    return roots


def test_train_dp_artifacts_equal_the_plain_run(plain_and_dp):
    a = _arrays(plain_and_dp["dp"], "synthetic", "pretext")
    b = _arrays(plain_and_dp["plain"], "synthetic", "pretext")
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_mine_dp_neighbours_equal_the_plain_run(plain_and_dp):
    name = os.path.join("out", "synthetic", "top3-train-neighbors.npy")
    np.testing.assert_array_equal(
        np.load(os.path.join(plain_and_dp["dp"], name)),
        np.load(os.path.join(plain_and_dp["plain"], name)))


def test_ragged_train_dp_batch_is_trimmed(tmp_path):
    """10 images, batch 64, train_dp 4: the whole-set fallback batch is
    trimmed to 8 (with tpu_ac's warning) instead of failing; the batches
    come from the pool's worker processes."""
    exp = (EXP.replace("synthetic_per_class: 8", "synthetic_per_class: 5")
           .replace("batch_size: 8", "batch_size: 64")
           .replace("num_workers: 0", "num_workers: 2") + "train_dp: 4\n")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _run(("simclr",), *_cfg(str(tmp_path), exp))
    assert any("trimmed 10 -> 8" in str(w.message) for w in caught)
    assert os.path.isdir(glob.glob(os.path.join(
        str(tmp_path), "out", "synthetic", "pretext", "model-*"))[0])


@pytest.fixture(scope="module")
def imagefolder(tmp_path_factory):
    """<root>/{train,val}/<wnid>/*.png (72 x 80) and a subset file, as
    tests/test_scan_cli.py builds them."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    wnids = ["n01000001", "n01000002"]
    for split, n in (("train", 6), ("val", 3)):
        for ci, wnid in enumerate(wnids):
            d = root / split / wnid
            d.mkdir(parents=True)
            for i in range(n):
                arr = np.zeros((72, 80, 3), np.uint8)
                arr[..., ci] = 200
                arr += rng.integers(0, 40, arr.shape).astype(np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.png")
    subset = root / "subset.txt"
    subset.write_text("".join(f"{w} class_{i}\n"
                              for i, w in enumerate(wnids)))
    return str(root), str(subset)


def test_moco_stage_loads_the_checkpoint_and_mines(imagefolder, tmp_path):
    data_root, subset = imagefolder
    cfg = ts.SCANModelConfig(backbone=RESNET50_IMAGENET, feature_dim=16,
                             n_clusters=2)
    p, bn = ts.init_contrastive_model(1, cfg, "cpu")
    sd = {}
    for k, v in {**p, **bn}.items():
        name = ("fc." + k[len("contrastive_head."):]
                if k.startswith("contrastive_head.") else k)
        sd["module.encoder_q." + name] = v
    sd["module.encoder_q.bn1.num_batches_tracked"] = torch.tensor(3)
    sd["module.encoder_k.conv1.weight"] = torch.ones_like(p["conv1.weight"])
    sd["module.queue"] = torch.zeros(16, 8)
    pth = str(tmp_path / "moco_v2.pth.tar")
    torch.save({"state_dict": sd, "epoch": 800}, pth)
    env = tmp_path / "env.yml"
    env.write_text(f"root_dir: {tmp_path}/artifacts\ndata_root: {data_root}\n")
    exp = tmp_path / "exp.yml"
    exp.write_text(
        "setup: moco\ntrain_db_name: imagenet_50\nbackbone: resnet50\n"
        "num_classes: 2\nimage_size: 64\nfeature_dim: 16\nbatch_size: 4\n"
        "num_neighbors: 2\nepochs: 1\nnum_workers: 0\n"
        f"moco_checkpoint: {pth}\nsubset_file: {subset}\n")
    _run(("moco",), str(env), str(exp))
    base = tmp_path / "artifacts" / "imagenet_50"
    (path,) = glob.glob(str(base / "pretext" / "model-*"))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        got = [z[f"leaf_{i}"] for i in range(len(z.files))]
    want = j_remap(sd)
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    # the checkpoint's leaves, jax.tree.flatten's order: "bn" then
    # "params", each dict by sorted key
    pnames = sorted(k for k in want if not k.endswith(("running_mean",
                                                       "running_var")))
    bnames = sorted(k for k in want if k.endswith(("running_mean",
                                                   "running_var")))
    assert len(got) == len(pnames) + len(bnames)
    for a, k in zip(got, bnames + pnames):
        np.testing.assert_array_equal(a, np.asarray(want[k]))
    assert np.load(base / "top2-train-neighbors.npy").shape == (12, 3)
    assert np.load(base / "top5-val-neighbors.npy").shape == (6, 6)
    # the moco -> scan handoff: run_scan's optimizer-free template
    # restores the pretext model moco wrote
    q, qbn = ts.init_contrastive_model(0, cfg, "cpu")
    pre, _ = restore_checkpoint(path, {"params": q, "bn": qbn})
    torch.testing.assert_close(pre["params"]["conv1.weight"],
                               p["conv1.weight"], rtol=0, atol=0)
