"""Copydays copy detection in both packages (tpu_ac.train.copy_detection
+ cli.eval_copy_detection vs tpu_ac_torch's with --device cpu) on one
synthetic Copydays tree with distractor and whitening dirs, the same
seeded backbone.

Equal: ``gem_cls_features`` within 1e-5; ``copydays_eval`` per-block mAP
to 1e-6 on the same features, whitened (PARITY #18: the UNCENTERED
second moment) and not; each CLI's printed lines and returned mAPs
(1e-6); the port's --dp run against its plain run.
"""

import contextlib
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from tpu_ac.cli import eval_copy_detection as jcli
from tpu_ac.models import registry as jreg
from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac.train import copy_detection as jcd
from tpu_ac_torch.cli import eval_copy_detection as tcli
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models.vit import ViTConfig as TViTConfig
from tpu_ac_torch.train import copy_detection as tcd

ARCH = "tiny_torch_copydetect"
CFG = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, img_size=32)


@pytest.fixture(scope="module", autouse=True)
def arch():
    jreg.register_backbone(ARCH, jreg.BackboneSpec("vit", JViTConfig(**CFG),
                                                   None))
    treg.register_backbone(ARCH, treg.BackboneSpec("vit", TViTConfig(**CFG),
                                                   None))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(copydays root, distractors dir, whitening dir): 4 originals, a
    noised copy of each in every jpegqual/crops block, 2 'strong' images
    whose 4-char prefixes match originals 0 and 2; 5 distractors, 12
    whitening images (non-square: the CLI resizes to a square)."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("copydays")
    bases = [rng.integers(0, 255, (32, 40, 3)).astype(np.uint8)
             for _ in range(4)]
    names = ["2000.jpg", "2001.jpg", "2002.jpg", "2003.jpg"]

    def save(block, fnames, arrays):
        d = root / block
        d.mkdir(parents=True, exist_ok=True)
        for fname, a in zip(fnames, arrays):
            Image.fromarray(a).save(d / fname)

    def noised(scale):
        return [np.clip(b.astype(int) + rng.integers(-scale, scale, b.shape),
                        0, 255).astype(np.uint8) for b in bases]

    save("original", names, bases)
    save("strong", ["2000_strong.jpg", "2002_strong.jpg"],
         [noised(30)[0], noised(30)[2]])
    for lvl in jcd.JPEG_LEVELS:
        save(f"jpegqual/{lvl}", names, noised(10))
    for lvl in jcd.CROP_LEVELS:
        save(f"crops/{lvl}", names, noised(10))
    extra = {}
    for d, n in (("distractors", 5), ("whitening", 12)):
        save(d, [f"{i:03d}.png" for i in range(n)],
             [rng.integers(0, 255, (36, 28, 3)).astype(np.uint8)
              for _ in range(n)])
        extra[d] = str(root / d)
    return str(root), extra["distractors"], extra["whitening"]


def _args(tree, extra=()):
    root, dis, whit = tree
    return ["--arch", ARCH, "--data_path", root, "--imsize", "40",
            "--batch_size_per_gpu", "8", "--distractors_path", dis,
            "--whitening_path", whit, *extra]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    return res, [ln for ln in buf.getvalue().splitlines() if "mAP=" in ln]


@pytest.fixture(scope="module")
def runs(tree):
    return {"jax": _run(jcli.main, _args(tree)),
            "torch": _run(tcli.main, _args(tree, ["--device", "cpu"])),
            "torch_dp": _run(tcli.main, _args(tree, ["--device", "cpu",
                                                     "--dp"]))}


def test_cli_matches_tpu_ac(runs):
    jres, jlines = runs["jax"]
    tres, tlines = runs["torch"]
    assert tlines == jlines and len(tlines) == 20
    assert list(tres) == list(jres)
    for block in jres:
        assert abs(tres[block] - jres[block]) <= 1e-6, block


def test_cli_dp_equals_plain(runs):
    assert runs["torch_dp"] == runs["torch"]


def test_cli_keeps_tpu_ac_flags():
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions}
    tflags = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert tflags.pop("device") == "cuda"
    assert tflags == jflags


def test_load_paths_square_resize(tree):
    """uint8 square resizes, normalized on the device to tpu_ac's f32
    images bit for bit."""
    from tpu_ac_torch.data.mvtec import normalize_on_device

    paths = tcd.CopydaysDataset(tree[0]).database_paths()
    got = tcli.load_paths(paths, 40)
    assert got.shape == (4, 3, 40, 40) and got.dtype == np.uint8
    want = jcli._load_paths(paths, 40)
    np.testing.assert_array_equal(
        normalize_on_device(torch.from_numpy(got)).numpy(), want)


def test_gem_cls_features_matches():
    tokens = np.random.default_rng(1).standard_normal(
        (3, 17, 8)).astype(np.float32)
    want = jcd.gem_cls_features(jnp.asarray(tokens))
    got = tcd.gem_cls_features(torch.from_numpy(tokens))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("whiten", [False, True])
def test_copydays_eval_matches(tree, whiten):
    ds_j, ds_t = jcd.CopydaysDataset(tree[0]), tcd.CopydaysDataset(tree[0])
    _, sizes = ds_t.query_paths()
    rng = np.random.default_rng(2)
    db = rng.standard_normal((4, 12)).astype(np.float32)
    q = np.concatenate([db[[i % 4 for i in range(sz)]] for sz in sizes])
    q = (q + 0.7 * rng.standard_normal(q.shape)).astype(np.float32)
    dis = rng.standard_normal((6, 12)).astype(np.float32)
    whit = (rng.standard_normal((30, 12)) + 0.5).astype(np.float32) \
        if whiten else None
    want = jcd.copydays_eval(q, db, ds_j, sizes, distractor_features=dis,
                             whitening_features=whit)
    got = tcd.copydays_eval(q, db, ds_t, sizes, distractor_features=dis,
                            whitening_features=whit, device="cpu")
    assert list(got) == ds_t.block_names
    for block in want:
        assert abs(got[block] - want[block]) <= 1e-6, block
    assert any(v < 1.0 for v in got.values())  # the noise costs ranks
