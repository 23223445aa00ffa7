"""The clustering sweep (``cli.main``) on the XCiT family: tpu_ac_torch vs
tpu_ac on one synthetic category, with tpu_ac's TINY XCiT (patch 8, width
32, depth 3) registered under one name in both registries, tapped at
blocks.1 + blocks.2 (28 x 28 tokens at 224 px), ``--precision highest``.

Reference side: tpu_ac's CLI takes its dp-mesh alpha on the 8 virtual CPU
devices of tests/conftest.py, as in tests/test_torch_pipeline.py.
Tolerances are that file's: alpha rtol 1e-3, atol 5e-4 (the self-term
floor of the kernel arithmetic through the softmax), X rtol 1e-3 with an
atol of 1e-3 x max|X|.
"""

import os
import pickle

import numpy as np

from tpu_ac.cli.main import main as jax_main
from tpu_ac.data import make_synthetic_mvtec
from tpu_ac.models import registry as jreg
from tpu_ac.models import xcit as jx
from tpu_ac_torch.cli.main import main as torch_main
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import xcit as tx

NAME = "tiny_sweep_xcit"
CFG = dict(patch_size=8, embed_dim=32, depth=3, num_heads=4,
           cls_attn_layers=2)
COMMON = ["--backbone_names", NAME,
          "--layers_to_extract_from", "blocks.1", "blocks.2",
          "--pretrain_embed_dimension", "64",
          "--target_embed_dimension", "96", "--categories", "bottle",
          "--supervised", "unsupervised", "--batch_size", "4",
          "--precision", "highest"]


def _pickle(out):
    path = os.path.join(out, "mvtec_ad", NAME, "unsupervised",
                        "blocks.1_blocks.2_64_96_1.0_1.0",
                        "matrix_alpha_X_bottle_unsupervised.pickle")
    with open(path, "rb") as f:
        return pickle.load(f)


def test_xcit_sweep_pickles_match(tmp_path):
    root = str(tmp_path / "mvtec")
    make_synthetic_mvtec(root, classname="bottle", image_size=64)
    jreg.register_backbone(NAME, jreg.BackboneSpec(
        "xcit", jx.XCiTConfig(**CFG), None))
    treg.register_backbone(NAME, treg.BackboneSpec(
        "xcit", tx.XCiTConfig(**CFG), None))
    outs = {}
    for tag, stage1, extra in (("jax", jax_main, []),
                               ("torch", torch_main, ["--device", "cpu"])):
        outs[tag] = str(tmp_path / tag)
        stage1(["--path", root, "--output_dir", outs[tag], *COMMON, *extra])
    ja, jx_ = _pickle(outs["jax"])
    ta, tx_ = _pickle(outs["torch"])
    assert ta.shape == ja.shape == (12, 1, 784)
    assert tx_.shape == jx_.shape == (12, 96)
    assert ta.dtype == tx_.dtype == np.float32
    np.testing.assert_allclose(ta, ja, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(tx_, jx_, rtol=1e-3,
                               atol=1e-3 * np.abs(jx_).max())
