"""Two flags of tpu_ac that the port lacked: ``cli.evaluate --visualize``
(accepted, and it raises naming the viz port's ROADMAP item) and
``MVTecDataset(train_val_split=...)`` with the VAL split, which lists the
same files as tpu_ac's on a synthetic tree."""

import os
import shutil

import pytest

from tpu_ac.data import make_synthetic_mvtec
from tpu_ac.data import mvtec as jmvtec
from tpu_ac_torch.cli.evaluate import build_parser
from tpu_ac_torch.cli.evaluate import main as torch_eval
from tpu_ac_torch.data import mvtec as tmvtec


def test_evaluate_visualize_parses_and_raises(tmp_path):
    args = build_parser().parse_args(["--visualize"])
    assert args.visualize
    assert not build_parser().parse_args([]).visualize
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        torch_eval(["--visualize", "--output_dir", str(tmp_path)])


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
