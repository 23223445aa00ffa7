"""Revisited Oxford/Paris retrieval in both packages (tpu_ac.data.
oxford_paris + cli.eval_image_retrieval vs tpu_ac_torch's with --device
cpu) on one synthetic tree, the same seeded backbone.

Equal: the synthetic trees byte for byte; the dataset's images bit for
bit; the CLI's printed lines and mAPs (1e-6), plain and --multiscale 1;
the port's shape-bucketed --dp run against its per-image run (features
within 1e-5).  The --dp extractor's host buffer stays within its budget
on a split of many distinct shapes, and its features keep the per-image
path's values and order.
"""

import contextlib
import filecmp
import io
import os
import pickle

import numpy as np
import pytest
import torch

from tpu_ac.cli import eval_image_retrieval as jcli
from tpu_ac.data import oxford_paris as jop
from tpu_ac.models import registry as jreg
from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac_torch.cli import eval_image_retrieval as tcli
from tpu_ac_torch.data import oxford_paris as top
from tpu_ac_torch.data.mvtec import normalize_on_device
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models.vit import ViTConfig as TViTConfig

ARCH = "tiny_torch_retrieval"
CFG = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, img_size=32)


@pytest.fixture(scope="module", autouse=True)
def arch():
    jreg.register_backbone(ARCH, jreg.BackboneSpec("vit", JViTConfig(**CFG),
                                                   None))
    treg.register_backbone(ARCH, treg.BackboneSpec("vit", TViTConfig(**CFG),
                                                   None))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(tpu_ac's tree, the port's tree) from the same seed."""
    j = tmp_path_factory.mktemp("rox_jax")
    t = tmp_path_factory.mktemp("rox_torch")
    kw = dict(n_db=22, n_q=5, image_size=44, seed=3)
    return jop.make_synthetic_roxford(str(j), **kw), \
        top.make_synthetic_roxford(str(t), **kw)


def test_synthetic_trees_are_byte_equal(trees):
    j, t = (os.path.join(r, "roxford5k") for r in trees)
    names = sorted(os.listdir(os.path.join(j, "jpg")))
    assert names == sorted(os.listdir(os.path.join(t, "jpg")))
    assert len(names) == 27
    _, mismatch, errors = filecmp.cmpfiles(os.path.join(j, "jpg"),
                                           os.path.join(t, "jpg"), names,
                                           shallow=False)
    assert not mismatch and not errors
    with open(os.path.join(j, "gnd_roxford5k.pkl"), "rb") as f:
        jg = pickle.load(f)
    with open(os.path.join(t, "gnd_roxford5k.pkl"), "rb") as f:
        tg = pickle.load(f)
    assert jg["imlist"] == tg["imlist"] and jg["qimlist"] == tg["qimlist"]
    for a, b in zip(jg["gnd"], tg["gnd"]):
        for key in ("easy", "hard", "junk", "bbx"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("split", ["train", "query"])
def test_dataset_images_equal(trees, split):
    jd = jop.OxfordParisDataset(trees[1], "roxford5k", split, imsize=40)
    td = top.OxfordParisDataset(trees[1], "roxford5k", split, imsize=40)
    assert len(td) == len(jd) and td.cfg["n"] == 22 and td.cfg["nq"] == 5
    for i in (0, len(td) - 1):
        want = jd[i]
        np.testing.assert_array_equal(td[i], want)
        u8 = td.load_uint8(i)
        assert u8.shape == want.shape == (3, 40, 40)
        np.testing.assert_array_equal(
            normalize_on_device(torch.from_numpy(u8[None]))[0].numpy(), want)


def test_revisited_splits_equal():
    gnd = [{"easy": [0, 1], "hard": [2], "junk": [3]},
           {"easy": [], "hard": [4, 5], "junk": []}]
    for (jm, jh), (tm, th) in [(jop.revisited_splits(gnd),
                                top.revisited_splits(gnd))]:
        for a, b in zip(jm + jh, tm + th):
            for key in ("ok", "junk"):
                np.testing.assert_array_equal(a[key], b[key])


def test_unknown_dataset_rejected(trees):
    with pytest.raises(ValueError):
        top.OxfordParisDataset(trees[1], "oxford5k", "train")


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    return res, [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(">>")]


def _args(root, extra=()):
    return ["--arch", ARCH, "--data_path", root, "--imsize", "40", *extra]


@pytest.mark.parametrize("multiscale", ["0", "1"])
def test_cli_matches_tpu_ac(trees, multiscale):
    jres, jlines = _run(jcli.main, _args(trees[0], ["--multiscale",
                                                    multiscale]))
    tres, tlines = _run(tcli.main, _args(trees[1], ["--multiscale",
                                                    multiscale,
                                                    "--device", "cpu"]))
    assert tlines == jlines and len(tlines) == 2
    for key in ("mAP_M", "mAP_H"):
        assert abs(tres[key] - jres[key]) <= 1e-6
    for key in ("mP@k_M", "mP@k_H"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1e-6)


def test_cli_dp_equals_plain(trees):
    plain = _run(tcli.main, _args(trees[1], ["--device", "cpu"]))
    dp = _run(tcli.main, _args(trees[1], ["--device", "cpu", "--dp"]))
    assert dp[1] == plain[1]


def test_cli_keeps_tpu_ac_flags():
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions}
    tflags = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert tflags.pop("device") == "cuda"
    assert tflags == jflags


class _ManyShapes:
    """A split of 100 images in 25 distinct shapes, in an order that
    interleaves them: no shape fills a buffer (16 on a 2-rank mesh), so
    without the budget every image would wait in a partial buffer."""

    def __init__(self):
        rng = np.random.default_rng(4)
        shapes = [(3, 16 + 8 * (i % 5), 16 + 8 * (i // 5)) for i in range(25)]
        self.images = [rng.integers(0, 255, shapes[i % 25], dtype=np.uint8)
                       for i in range(100)]

    def __len__(self):
        return len(self.images)

    def load_uint8(self, i):
        return self.images[i]


class _Recording(tcli.ShapeBuckets):
    last = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        type(self).last = self


def test_dp_buffer_stays_bounded(monkeypatch):
    from tpu_ac_torch.models.convert import load_jax_params
    from tpu_ac_torch.models.vit import ViT, init_vit_params

    cfg = TViTConfig(**CFG)
    model = load_jax_params(ViT(cfg), init_vit_params(0, cfg)).eval()
    ds = _ManyShapes()
    monkeypatch.setattr(tcli, "ShapeBuckets", _Recording)
    with torch.inference_mode():
        plain = tcli.extract_split_features(model.forward_cls, ds,
                                            device="cpu")
        bucketed = tcli.extract_split_features(model.forward_cls, ds,
                                               mesh=Mesh(["cpu"] * 2))
    buckets = _Recording.last
    budget = tcli.BUFFERED_BATCHES * 16
    assert budget < len(ds)
    assert buckets.peak == budget
    assert buckets.n_buffered == 0 and not buckets.buffers
    assert bucketed.shape == plain.shape == (100, 32)
    np.testing.assert_allclose(bucketed, plain, rtol=1e-5, atol=1e-5)


def test_shape_buckets_flush_the_largest_first():
    flushed = []
    b = tcli.ShapeBuckets(cap=4, budget=5,
                          flush=lambda s, items: flushed.append(
                              (s, [i for i, _ in items])))
    a, c = np.zeros((1, 2)), np.zeros((2, 1))
    for i, im in enumerate([a, a, c, a, c]):
        b.add(i, im)
    assert flushed == [] and b.n_buffered == 5
    b.add(5, c)  # past the budget: the largest buffer (shape a) goes
    assert flushed == [((1, 2), [0, 1, 3])] and b.n_buffered == 3
    b.add(6, c)  # shape c fills its cap of 4
    assert flushed[-1] == ((2, 1), [2, 4, 5, 6]) and b.n_buffered == 0
    b.close()
    assert b.peak == 5
    with pytest.raises(ValueError, match="budget"):
        tcli.ShapeBuckets(cap=8, budget=4, flush=print)
