"""Two flags of tpu_ac that the port lacked: ``cli.evaluate --visualize``
(it parses, and with a stage-1 pickle writes one alpha figure per anomaly
type; ``tests/test_torch_viz_clis.py`` holds its figures to tpu_ac's) and
``MVTecDataset(train_val_split=...)`` with the VAL split, which lists the
same files as tpu_ac's on a synthetic tree."""

import os
import pickle
import shutil

import numpy as np
import pytest

from tpu_ac.data import make_synthetic_mvtec
from tpu_ac.data import mvtec as jmvtec
from tpu_ac_torch.cli.evaluate import build_parser
from tpu_ac_torch.cli.evaluate import main as torch_eval
from tpu_ac_torch.data import mvtec as tmvtec


def test_evaluate_visualize_parses_and_raises(tree, tmp_path):
    """--visualize parses and runs: no raise, one figure per anomaly type
    of bottle under visualize/<run-name>/."""
    args = build_parser().parse_args(["--visualize"])
    assert args.visualize
    assert not build_parser().parse_args([]).visualize
    n = len(tmvtec.MVTecDataset(tree, "bottle",
                                split=tmvtec.DatasetSplit.TEST))
    d = os.path.join(str(tmp_path), "mvtec_ad", "vit", "unsupervised",
                     "blocks.1_8_8_1.0_1.0")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "matrix_alpha_X_bottle_unsupervised.pickle"),
              "wb") as f:
        pickle.dump((rng.random((n, 1, 4)).astype(np.float32),
                     rng.random((n, 8)).astype(np.float32)), f)
    torch_eval(["--visualize", "--path", tree, "--output_dir",
                str(tmp_path), "--backbone_names", "vit",
                "--layers_to_extract_from", "blocks.1",
                "--pretrain_embed_dimension", "8",
                "--target_embed_dimension", "8", "--tau_list", "1.0",
                "--supervised_modes", "unsupervised", "--categories",
                "bottle"])
    vis = os.path.join(str(tmp_path), "mvtec_ad", "visualize",
                       "vit_8_8_blocks.1_1.0_unsupervised")
    assert sorted(os.listdir(vis)) == [
        "bottle_broken_large.png", "bottle_contamination.png",
        "bottle_good.png"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two categories with a val/ folder (a copy of train/), odd counts so
    the cut rounds down."""
    root = str(tmp_path_factory.mktemp("mvtec"))
    for cat, n in (("bottle", 5), ("screw", 7)):
        make_synthetic_mvtec(root, classname=cat, n_per_anomaly=3,
                             n_train=n, image_size=16, seed=n)
        shutil.copytree(os.path.join(root, cat, "train"),
                        os.path.join(root, cat, "val"))
    return root


def _listing(ds):
    return [(it.classname, it.anomaly, it.image_path, it.mask_path)
            for it in ds.items]


@pytest.mark.parametrize("split", ["TRAIN", "VAL", "TEST"])
@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("classname", ["bottle", None])
def test_train_val_split_lists_the_same_files(tree, split, ratio, classname,
                                              monkeypatch):
    # classname None walks every class of the list: the tree's two here
    monkeypatch.setattr(jmvtec, "CLASSNAMES", ["screw", "bottle"])
    monkeypatch.setattr(tmvtec, "CLASSNAMES", ["screw", "bottle"])
    want = jmvtec.MVTecDataset(tree, classname, split=getattr(
        jmvtec.DatasetSplit, split), train_val_split=ratio)
    got = tmvtec.MVTecDataset(tree, classname, split=getattr(
        tmvtec.DatasetSplit, split), train_val_split=ratio)
    assert _listing(got) == _listing(want)
    assert got.items
    if split != "TEST" and classname == "bottle":
        assert len(got) == {("TRAIN", 0.5): 2, ("VAL", 0.5): 3}.get(
            (split, ratio), 5)
