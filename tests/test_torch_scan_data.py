"""The port's SCAN config and data (tpu_ac_torch.config, data.
classification, the SCAN half of data.augment, the process pool of
data.prefetch) against tpu_ac's, on the CPU.  Everything here is numpy and
PIL on the host, so the tolerance is equality: the same config values and
paths, the same decoded arrays, the same batches and bit-equal
augmentations for a seed."""

import os
import pickle
import random
import warnings

import numpy as np
import pytest
from PIL import Image

import tpu_ac.config as jconfig
from tpu_ac.data import augment as jaug
from tpu_ac.data import classification as jcls
import tpu_ac_torch.config as tconfig
from tpu_ac_torch.data import augment as taug
from tpu_ac_torch.data import classification as tcls
from tpu_ac_torch.data.prefetch import ParallelAugPool

J_CONFIGS = os.path.join(os.path.dirname(jconfig.__file__), "configs")
CONFIG_FILES = sorted(
    os.path.relpath(os.path.join(d, n), J_CONFIGS)
    for d, _, names in os.walk(J_CONFIGS) for n in names
    if n.endswith(".yml"))


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------

def test_config_merge_and_attribute_access():
    base = {"model": {"dim": 64, "depth": 2}, "lr": 0.1, "xs": [{"a": 1}]}
    over = {"model": {"dim": 128}, "extra": True}
    want = jconfig.merge(jconfig.Config.wrap(base), over)
    got = tconfig.merge(tconfig.Config.wrap(base), over)
    assert got == want
    assert got.model.dim == 128 and got.model.depth == 2
    assert got.xs[0].a == 1
    with pytest.raises(AttributeError):
        got.missing


def test_create_config_paths_equal_tpu_ac(tmp_path):
    env = tmp_path / "env.yml"
    env.write_text(f"root_dir: {tmp_path}/out\ndata_root: {tmp_path}\n")
    exp = tmp_path / "exp.yml"
    exp.write_text("train_db_name: cifar-10\nnum_neighbors: 20\nlr: 0.4\n"
                   "num_neighbors_val: 7\n")
    got = tconfig.create_config(str(env), str(exp))
    assert got == jconfig.create_config(str(env), str(exp))
    assert got.topk_neighbors_train_path.endswith(
        "cifar-10/top20-train-neighbors.npy")
    assert got.topk_neighbors_val_path.endswith("top7-val-neighbors.npy")
    for stage in ("pretext", "scan", "selflabel"):
        assert os.path.isdir(got[f"{stage}_dir"])


@pytest.mark.parametrize("rel", CONFIG_FILES)
def test_config_files_are_tpu_ac_s(rel):
    """The port's own copy of every experiment file reads as tpu_ac's."""
    mine = os.path.join(tconfig.CONFIG_DIR, rel)
    theirs = os.path.join(J_CONFIGS, rel)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert tconfig.load_yaml(mine) == jconfig.load_yaml(theirs)


def test_config_dir_holds_the_18_experiments():
    assert len([r for r in CONFIG_FILES if "/" in r]) == 18
    assert "env.yml" in CONFIG_FILES


# --------------------------------------------------------------------------
# Loaders, on tiny files in the real formats
# --------------------------------------------------------------------------

def _same_dataset(a, b):
    np.testing.assert_array_equal(np.asarray(a.images), np.asarray(b.images))
    assert a.images.dtype == b.images.dtype == np.uint8
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.classes == b.classes


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """cifar-10-batches-py, cifar-100-python and stl10_binary with a few
    rows each, and an ImageFolder tree with a subset file."""
    root = tmp_path_factory.mktemp("scan_data")
    rng = np.random.default_rng(0)
    c10 = root / "cifar-10-batches-py"
    c10.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(c10 / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 4).tolist()}, f)
    c100 = root / "cifar-100-python"
    c100.mkdir()
    for name in ("train", "test"):
        with open(c100 / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (6, 3072),
                                               dtype=np.uint8),
                         b"fine_labels": rng.integers(0, 100, 6).tolist()},
                        f)
    stl = root / "stl10_binary"
    stl.mkdir()
    for split in ("train", "test"):
        (stl / f"{split}_X.bin").write_bytes(
            rng.integers(0, 256, 3 * 3 * 96 * 96, dtype=np.uint8).tobytes())
        (stl / f"{split}_y.bin").write_bytes(
            rng.integers(1, 11, 3, dtype=np.uint8).tobytes())
    wnids = ["n01000001", "n01000002", "n01000003"]
    for split in ("train", "val"):
        for ci, wnid in enumerate(wnids):
            d = root / "inet" / split / wnid
            d.mkdir(parents=True)
            for i in range(2):
                arr = rng.integers(0, 256, (40 + 8 * ci, 48, 3),
                                   dtype=np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.png")
    (root / "subset.txt").write_text("n01000002 two\nn01000001 one\n")
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar10(data_root, split):
    got = tcls.load_cifar10(str(data_root), split)
    _same_dataset(got, jcls.load_cifar10(str(data_root), split))
    assert len(got) == (20 if split == "train" else 4)


@pytest.mark.parametrize("split", ["train", "val"])
def test_cifar20(data_root, split):
    got = tcls.load_cifar20(str(data_root), split)
    _same_dataset(got, jcls.load_cifar20(str(data_root), split))
    assert got.labels.max() < 20


@pytest.mark.parametrize("split", ["train", "test"])
def test_stl10(data_root, split):
    got = tcls.load_stl10(str(data_root), split)
    _same_dataset(got, jcls.load_stl10(str(data_root), split))
    assert got.images.shape == (3, 96, 96, 3)


@pytest.mark.parametrize("subset", [True, False], ids=["subset", "all"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_imagenet(data_root, split, subset):
    sub = str(data_root / "subset.txt") if subset else None
    got = tcls.load_imagenet(str(data_root / "inet"), split,
                             subset_file=sub, size=32)
    _same_dataset(got, jcls.load_imagenet(str(data_root / "inet"), split,
                                          subset_file=sub, size=32))
    assert len(got) == (4 if subset else 6)


def test_imagenet_mmap_cache_crosses_packages(data_root, tmp_path):
    """The same cache file name and bytes; each package reads the
    other's cache."""
    root = str(data_root / "inet")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    got = tcls.load_imagenet(root, "train", size=32, mmap_cache=a)
    want = jcls.load_imagenet(root, "train", size=32, mmap_cache=b)
    assert isinstance(got.images, np.memmap)
    assert os.listdir(a) == os.listdir(b)
    _same_dataset(got, want)
    _same_dataset(tcls.load_imagenet(root, "train", size=32, mmap_cache=b),
                  jcls.load_imagenet(root, "train", size=32, mmap_cache=a))


def test_imagenet_subset_listing(data_root):
    args = (str(data_root / "inet"), str(data_root / "subset.txt"), "val")
    got, want = tcls.load_imagenet_subset(*args), \
        jcls.load_imagenet_subset(*args)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


def test_synthetic_dataset_and_items():
    got = tcls.make_synthetic_classification(5, 3, 24, seed=4)
    _same_dataset(got, jcls.make_synthetic_classification(5, 3, 24, seed=4))
    item = got[7]
    assert item["target"] == 1 and item["meta"] == {"index": 7}
    assert item["image"].size == (24, 24)


# --------------------------------------------------------------------------
# Batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs,mult", [
    (50, 8, 1), (50, 8, 4), (50, 7, 4), (10, 100, 4), (10, 100, 1),
    (16, 16, 2), (5, 3, 1)])
def test_shuffled_batches_equal_tpu_ac(n, bs, mult):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = list(tcls.shuffled_batches(n, bs, 3, multiple_of=mult))
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = list(jcls.shuffled_batches(n, bs, 3, multiple_of=mult))
    assert len(got) == len(want) == tcls.num_shuffled_batches(n, bs, mult) \
        == jcls.num_shuffled_batches(n, bs, mult)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert len(a) % mult == 0
    assert [str(w.message) for w in got_w] == [str(w.message)
                                              for w in want_w]


@pytest.mark.parametrize("n,bs", [(3, 100), (100, 3), (0, 4)])
def test_shuffled_batches_refuses_like_tpu_ac(n, bs):
    for mod in (tcls, jcls):
        with pytest.raises(ValueError) as err:
            list(mod.shuffled_batches(n, bs, 0, multiple_of=4))
        if n:
            assert "train_dp" in str(err.value)


# --------------------------------------------------------------------------
# Augmentations and the wrapper datasets
# --------------------------------------------------------------------------

def _images(n=12, size=32):
    ds = tcls.make_synthetic_classification(n // 3, 3, size, seed=1)
    return [ds.get_pil(i) for i in range(n)]


TRANSFORMS = {
    "simclr": (taug.SimCLRAugmentation, jaug.SimCLRAugmentation, {}),
    "strong": (taug.StrongAugmentation, jaug.StrongAugmentation, {}),
    "weak": (taug.WeakAugmentation, jaug.WeakAugmentation, {}),
    "simclr_96": (taug.SimCLRAugmentation, jaug.SimCLRAugmentation,
                  {"size": 96}),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_scan_transforms_bit_equal(name):
    tcls_, jcls_, kw = TRANSFORMS[name]
    t, j = tcls_(seed=0, **kw), jcls_(seed=0, **kw)
    for i, img in enumerate(_images()):
        key = f"0/s/0/{i}"
        got = t(img, rng=random.Random(key))
        want = j(img, rng=random.Random(key))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the instance stream (no rng argument) too
    for img in _images(3):
        np.testing.assert_array_equal(t(img), j(img))


@pytest.mark.parametrize("size", [32, 24, 40], ids=["equal", "crop", "pad"])
def test_val_transform_bit_equal(size):
    for img in _images(6):
        np.testing.assert_array_equal(taug.ValTransform(size)(img),
                                      jaug.ValTransform(size)(img))


def test_randaugment_and_cutout_bit_equal():
    for i, img in enumerate(_images()):
        got = taug.randaugment(img, 4, random.Random(i))
        want = jaug.randaugment(img, 4, random.Random(i))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        arr = taug.to_normalized_array(img)
        for random_hole in (True, False):
            np.testing.assert_array_equal(
                taug.cutout(arr, 2, 16, random.Random(i), random_hole),
                jaug.cutout(arr, 2, 16, random.Random(i), random_hole))
    assert len(taug._randaugment_ops(random.Random(0))) == 13


def test_augment_batch_bit_equal():
    imgs = _images(6)
    np.testing.assert_array_equal(
        taug.augment_batch(imgs, taug.WeakAugmentation(seed=2)),
        jaug.augment_batch(imgs, jaug.WeakAugmentation(seed=2)))


def test_augmented_dataset_pairs():
    t = tcls.AugmentedDataset(tcls.make_synthetic_classification(4, 2),
                              taug.WeakAugmentation(32, seed=0),
                              taug.SimCLRAugmentation(32, seed=0))
    j = jcls.AugmentedDataset(jcls.make_synthetic_classification(4, 2),
                              jaug.WeakAugmentation(32, seed=0),
                              jaug.SimCLRAugmentation(32, seed=0))
    assert len(t) == len(j) == 8
    got, want = t.batch(range(6)), j.batch(range(6))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert not np.allclose(got["image"], got["image_augmented"])


def test_neighbors_dataset_pairs():
    idx = np.tile(np.arange(8)[:, None], (1, 4))
    idx[:, 1:] = np.roll(idx[:, 1:], 1, axis=0)
    t = tcls.NeighborsDataset(tcls.make_synthetic_classification(4, 2),
                              taug.WeakAugmentation(32, seed=0), idx,
                              num_neighbors=2, seed=5)
    j = jcls.NeighborsDataset(jcls.make_synthetic_classification(4, 2),
                              jaug.WeakAugmentation(32, seed=0), idx,
                              num_neighbors=2, seed=5)
    assert t.indices.shape == (8, 3)
    item = t[2]
    np.testing.assert_array_equal(item["possible_neighbors"], idx[2, :3])
    j[2]  # the two rng streams in step
    got, want = t.batch(range(8)), j.batch(range(8))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("workers", [0, 2])
def test_process_pool_equals_tpu_ac_s_thread_pool(workers):
    """The port's pool (spawned worker processes) gives tpu_ac's pool's
    arrays for the same seed, stream, epoch and positions; so does the
    serial loop."""
    from tpu_ac.data.prefetch import ParallelAugPool as JPool

    ds = tcls.make_synthetic_classification(6, 3, 32, seed=0)
    idxs = [5, 0, 17, 3, 9, 11, 2]
    mine, theirs = ParallelAugPool(workers, seed=4), JPool(2, seed=4)
    try:
        for aug, jaug_, keyed in (
                (taug.StrongAugmentation(32, seed=0),
                 jaug.StrongAugmentation(32, seed=0), True),
                (taug.ValTransform(32), jaug.ValTransform(32), False)):
            got = mine.stack(aug, ds.get_pil, idxs, epoch=3, start=40,
                             stream="s", keyed=keyed)
            want = theirs.stack(jaug_, ds.get_pil, idxs, epoch=3, start=40,
                                stream="s", keyed=keyed)
            np.testing.assert_array_equal(got, want)
        got = list(mine.lookahead(lambda i=i: i * i for i in range(5)))
        assert got == [0, 1, 4, 9, 16]
    finally:
        mine.close()
        theirs.close()
