"""The port's DINO input pipeline and utilities against tpu_ac's: the
ImageFolder walk and its epoch batches (sharded too), the PIL multi-crop
and the crop prefetcher (bit-equal crops at 0 and 4 workers), LARS, the
checkpoint format (either package reads the other's), seeding, logging
and profiling.  Tolerances: equal, except LARS (f32, 1e-6)."""

import functools
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ac.data import augment as jaug
from tpu_ac.data import imagefolder as jif
from tpu_ac.data import prefetch as jpre
from tpu_ac.train import dino as jd
from tpu_ac.train import optim as joptim
from tpu_ac.utils import checkpoint as jckpt
from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac_torch.data import augment as taug
from tpu_ac_torch.data import imagefolder as tif
from tpu_ac_torch.data import prefetch as tpre
from tpu_ac_torch.models.vit import ViTConfig
from tpu_ac_torch.train import dino as td
from tpu_ac_torch.train import optim as toptim
from tpu_ac_torch.utils import checkpoint as tckpt
from tpu_ac_torch.utils import logging as tlog
from tpu_ac_torch.utils import profiling as tprof
from tpu_ac_torch.utils import seeding as tseed

AUG_KW = dict(local_crops_number=3, global_size=32, local_size=16)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two classes of 40 px images (tests/test_dino_cli.py's folder, one
    image wider than tall and one taller to reach the crops' fallbacks)."""
    root = tmp_path_factory.mktemp("dino_data")
    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        d = root / cls
        d.mkdir()
        for i in range(6):
            arr = rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
    Image.fromarray(rng.integers(0, 255, (12, 60, 3)).astype(np.uint8)).save(
        root / "a" / "wide.png")
    Image.fromarray(rng.integers(0, 255, (60, 12, 3)).astype(np.uint8)).save(
        root / "b" / "tall.jpg")
    (root / "b" / "notes.txt").write_text("not an image")
    return str(root)


def test_imagefolder_samples_equal(folder):
    j, t = jif.ImageFolder(folder), tif.ImageFolder(folder)
    assert t.samples == j.samples and t.class_to_idx == j.class_to_idx
    assert len(t) == len(j) == 14
    for i in (0, 6, 13):
        np.testing.assert_array_equal(np.asarray(t[i][0]),
                                      np.asarray(j[i][0]))
        assert t[i][1] == j[i][1]


@pytest.mark.parametrize("shards", [1, 3, 5])
@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_batches_equal(folder, shards, drop_last):
    j, t = jif.ImageFolder(folder), tif.ImageFolder(folder)
    for index in range(shards):
        kw = dict(seed=4, drop_last=drop_last, num_shards=shards,
                  shard_index=index)
        want = [b.tolist() for b in j.epoch_batches(3, **kw)]
        got = [b.tolist() for b in t.epoch_batches(3, **kw)]
        assert got == want


@pytest.mark.parametrize("normalize", [True, False])
def test_dino_augmentation_bit_equal(folder, normalize):
    ds = tif.ImageFolder(folder)
    jfn = jaug.DINOAugmentation(seed=1, normalize=normalize, **AUG_KW)
    tfn = taug.DINOAugmentation(seed=1, normalize=normalize, **AUG_KW)
    for i in range(len(ds)):  # the instance streams advance alike
        img = ds[i][0]
        want, got = jfn(img), tfn(img)
        assert len(got) == len(want) == 2 + AUG_KW["local_crops_number"]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # a private stream, as the prefetcher passes one
    img = ds[0][0]
    for a, b in zip(tfn(img, rng=random.Random("0/1/2")),
                    jfn(img, rng=random.Random("0/1/2"))):
        np.testing.assert_array_equal(a, b)


def test_elementary_ops_bit_equal(folder):
    img = tif.ImageFolder(folder)[0][0]
    for name, call in (
            ("random_resized_crop", lambda m, r: m.random_resized_crop(
                img, 24, (0.05, 0.4), rng=r)),
            ("color_jitter", lambda m, r: m.color_jitter(
                img, 0.4, 0.4, 0.2, 0.1, rng=r)),
            ("gaussian_blur_pil", lambda m, r: m.gaussian_blur_pil(
                img, rng=r)),
            ("solarize", lambda m, r: m.solarize(img))):
        want = np.asarray(call(jaug, random.Random(9)))
        got = np.asarray(call(taug, random.Random(9)))
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(taug.to_normalized_array(img),
                                  jaug.to_normalized_array(img))
    np.testing.assert_array_equal(taug.to_uint8_array(img),
                                  jaug.to_uint8_array(img))


@pytest.mark.parametrize("workers", [0, 4])
def test_crop_prefetcher_bit_equal(folder, workers):
    ds = tif.ImageFolder(folder)
    kw = dict(num_workers=workers, seed=3)
    n_local = AUG_KW["local_crops_number"]
    want_l = jpre.CropBatchPrefetcher(
        lambda i: ds[int(i)][0],
        jaug.DINOAugmentation(seed=3, normalize=False, **AUG_KW), n_local,
        **kw)
    got_l = tpre.CropBatchPrefetcher(
        lambda i: ds[int(i)][0],
        taug.DINOAugmentation(seed=3, normalize=False, **AUG_KW), n_local,
        transfer=tpre.to_device("cpu"), **kw)
    try:
        batches = [list(b) for b in ds.epoch_batches(4, seed=2)]
        want = list(want_l.batches(1, batches))
        got = list(got_l.batches(1, batches))
    finally:
        want_l.close()
        got_l.close()
    assert len(got) == len(want) == 3
    for (tg, tl), (jg, jl) in zip(got, want):
        assert isinstance(tg, torch.Tensor) and tg.dtype == torch.uint8
        np.testing.assert_array_equal(tg.numpy(), jg)
        np.testing.assert_array_equal(tl.numpy(), jl)


def test_base_prefetcher_and_parallel_decode_equal(folder):
    from tpu_ac.data import device_aug as jdev
    from tpu_ac_torch.data import device_aug as tdev

    ds = tif.ImageFolder(folder)
    batches = [list(b) for b in ds.epoch_batches(4, seed=0)]
    jl = jpre.BaseImagePrefetcher(lambda i: ds[int(i)][0], 24, num_workers=2)
    tl = tpre.BaseImagePrefetcher(lambda i: ds[int(i)][0], 24, num_workers=2,
                                  transfer=tpre.to_device("cpu"))
    try:
        for got, want in zip(tl.batches(0, batches), jl.batches(0, batches)):
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        jl.close()
        tl.close()

    def load(i):
        return tdev.load_base_image(ds[i][0], 20)

    want = np.stack([jdev.load_base_image(ds[i][0], 20) for i in range(8)])
    for workers in (0, 3):
        np.testing.assert_array_equal(
            tpre.parallel_decode(list(range(8)), load, workers), want)


def _first_crop(aug, img, rng):
    return aug(img, rng=rng)[0]


def test_parallel_aug_pool_equal(folder):
    ds = tif.ImageFolder(folder)
    aug_j = jaug.DINOAugmentation(seed=0, **AUG_KW)
    aug_t = taug.DINOAugmentation(seed=0, **AUG_KW)

    def first_crop(aug):
        # a module-level function: the port's pool pickles the transform
        # to its worker processes
        return functools.partial(_first_crop, aug)

    jp, tp = jpre.ParallelAugPool(3, seed=5), tpre.ParallelAugPool(3, seed=5)
    try:
        want = jp.stack(first_crop(aug_j), lambda i: ds[i][0], [0, 3, 5],
                        epoch=2, start=4, stream="s")
        got = tp.stack(first_crop(aug_t), lambda i: ds[i][0], [0, 3, 5],
                       epoch=2, start=4, stream="s")
        assert list(tp.lookahead([lambda: 1, lambda: 2])) == [1, 2]
    finally:
        jp.close()
        tp.close()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lr", [None, 0.1])
def test_lars_matches_tpu_ac(lr):
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((6,)).astype(np.float32),
              "z": np.zeros((3, 3), np.float32)}
    jopt = joptim.lars(lr, momentum=0.9, weight_decay=1e-4, eta=0.02)
    topt = toptim.lars(lr, momentum=0.9, weight_decay=1e-4, eta=0.02)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in
                              grads.items()}, ts, tp)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    with pytest.raises(ValueError):
        topt.update(tu, ts, None)


TINY_VIT = dict(patch_size=8, embed_dim=16, depth=1, num_heads=2,
                img_size=16)
TINY_CFG = dict(out_dim=8, local_crops_number=1, global_size=16,
                local_size=8, head_hidden_dim=8, head_bottleneck_dim=4)


def test_checkpoint_leaf_order_is_jaxs():
    jstate = jd.init_dino_state(0, JViTConfig(**TINY_VIT),
                                jd.DINOConfig(**TINY_CFG))
    tstate = td.init_dino_state(0, ViTConfig(**TINY_VIT),
                                td.DINOConfig(**TINY_CFG), device="cpu")
    want = jax.tree.leaves(jstate)
    got = tckpt.tree_flatten(tstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("writer", ["tpu_ac", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    jstate = jd.init_dino_state(0, JViTConfig(**TINY_VIT),
                                jd.DINOConfig(**TINY_CFG))
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32))
    tstate = td.dino_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    if writer == "tpu_ac":
        path = jckpt.save_checkpoint(str(tmp_path), "ck", jstate, step=3,
                                     extra={"epoch": 3})
        got, meta = tckpt.restore_checkpoint(path, tstate)
        want = tstate
    else:
        path = tckpt.save_checkpoint(str(tmp_path), "ck", tstate, step=3,
                                     extra={"epoch": 3})
        got, meta = jckpt.restore_checkpoint(path, jstate)
        want = jstate
    assert meta["extra"] == {"epoch": 3} and meta["step"] == 3
    assert type(got) is type(want)
    for a, b in zip(jax.tree.leaves(got) if writer == "port"
                    else tckpt.tree_flatten(got),
                    tckpt.tree_flatten(td.dino_state_to_numpy(tstate))):
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(f"{path}/meta.json") as f:
        assert json.load(f)["dtypes"][-1] == "int32"


def test_checkpoint_keep_prev_and_latest(tmp_path):
    state = {"a": torch.arange(3, dtype=torch.float32),
             "b": (torch.ones(2, dtype=torch.bfloat16), None)}
    d = str(tmp_path)
    assert tckpt.latest_checkpoint(d, "ck") is None
    for step in range(4):
        tckpt.save_checkpoint(d, "ck", state, step=step, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ck-00000002", "ck-00000003"]
    # same-step overwrite, and an interrupted one whose .prev survives
    path = tckpt.save_checkpoint(d, "ck", state, step=3)
    (tmp_path / "ck-00000009.prev").mkdir()
    assert tckpt.latest_checkpoint(d, "ck").endswith("ck-00000009.prev")
    got, meta = tckpt.restore_checkpoint(path, state)
    assert got["b"][1] is None and got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["a"], state["a"])
    # tpu_ac reads the bf16 leaf through its recorded dtype
    jgot, _ = jckpt.restore_checkpoint(path, {"a": np.zeros(3),
                                             "b": (np.zeros(2), None)})
    assert jgot["b"][0].dtype.name == "bfloat16"
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore_checkpoint(path, {"a": state["a"]})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {"a": torch.zeros(4),
                                        "b": state["b"]})


def test_seeding_and_generator():
    g1 = tseed.fix_seeds(5)
    a = (random.random(), np.random.random(), torch.rand(1).item(),
         torch.rand(1, generator=g1).item())
    g2 = tseed.fix_seeds(5)
    b = (random.random(), np.random.random(), torch.rand(1).item(),
         torch.rand(1, generator=g2).item())
    assert a == b
    assert tseed.fix_seeds(5, with_generator=False) is None


def test_metric_logger_and_lagged_fetch():
    lines = []
    logger = tlog.MetricLogger(printer=lines.append)
    seen = []
    fetch = tlog.LaggedFetch(seen.append)
    for i in logger.log_every(range(3), 2, "hdr"):
        fetch.push({"loss": torch.tensor(float(i)), "lr": 0.5})
        logger.update(loss=i)
        # each push resolves the one before it
        assert len(seen) == i
    fetch.flush()
    assert [float(s["loss"]) for s in seen] == [0.0, 1.0, 2.0]
    assert logger.loss.global_avg == 1.0 and logger.loss.max == 2
    assert logger.data_time.count == 3
    assert lines[0].startswith("hdr [0/3]") and "Total time" in lines[-1]
    logger.synchronize_between_processes()  # no process group: a no-op
    assert tlog.StepTimer.device_memory_mb() is None or \
        torch.cuda.is_available()
    with tlog.StepTimer() as t:
        pass
    assert len(t.times) == 1 and t.mean >= 0


def test_profile_writes_a_trace(tmp_path):
    d = str(tmp_path / "trace")
    with tprof.maybe_profile(d):
        with tprof.step_annotation("dino_step", step=3):
            torch.ones(4).sum()
    with open(f"{d}/trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "dino_step#3" in names
    with tprof.maybe_profile(None):
        pass
