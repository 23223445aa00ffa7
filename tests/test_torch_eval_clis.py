"""Both packages' k-NN and linear-probe CLIs (tpu_ac.cli.eval_{knn,
linear} and tpu_ac_torch's with --device cpu) on one synthetic
ImageFolder, the same seeded backbones (registered under one name in both
registries, no checkpoint: both take the seed-0 init, bit-identical).

Equal: every printed metric line; the k-NN --dump_features matrices within
1e-5 (f32 on both sides); the port's --dp 2 run (a CPU mesh of the host
repeated) against its plain run: the same lines, the features within 1e-5.
"""

import contextlib
import io

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ac.cli import eval_knn as jknn
from tpu_ac.cli import eval_linear as jlin
from tpu_ac.models import registry as jreg
from tpu_ac.models.resnet import ResNetConfig as JResNetConfig
from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac_torch.cli import eval_knn as tknn
from tpu_ac_torch.cli import eval_linear as tlin
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models.resnet import ResNetConfig as TResNetConfig
from tpu_ac_torch.models.vit import ViTConfig as TViTConfig

VIT = "tiny_torch_evalcli"
RESNET = "tiny_torch_evalcli_resnet"
VIT_CFG = dict(patch_size=8, embed_dim=32, depth=4, num_heads=2,
               img_size=32)
RESNET_CFG = dict(block_counts=(1, 1, 1, 1), expansion=1, block="basic")


@pytest.fixture(scope="module", autouse=True)
def archs():
    for reg, vit, res in ((jreg, JViTConfig, JResNetConfig),
                          (treg, TViTConfig, TResNetConfig)):
        reg.register_backbone(VIT, reg.BackboneSpec(
            "vit", vit(**VIT_CFG), None))
        reg.register_backbone(RESNET, reg.BackboneSpec(
            "resnet", res(**RESNET_CFG), None))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """train/ and val/ splits of two far-separated classes (dark vs
    bright), 6 + 4 images a class at 32 px."""
    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(0)
    for split, n_per_class in (("train", 6), ("val", 4)):
        for cls, base in (("class_a", 30), ("class_b", 220)):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n_per_class):
                arr = np.clip(base + rng.integers(-20, 20, (32, 32, 3)),
                              0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{i}.png")
    return str(root)


def _lines(main, argv, marker):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if marker in ln]
    assert lines, buf.getvalue()
    return lines


def _knn_args(folder, arch, dump):
    return ["--arch", arch, "--data_path", folder, "--nb_knn", "3", "5",
            "--imagesize", "32", "--batch_size_per_gpu", "8",
            "--dump_features", dump]


@pytest.fixture(scope="module")
def knn_runs(folder, tmp_path_factory):
    """{(package, arch, dp): (printed lines, dump)}."""
    out = tmp_path_factory.mktemp("knn")
    runs = {}
    for arch in (VIT, RESNET):
        dump = str(out / f"jax_{arch}.npz")
        runs["jax", arch, 0] = (_lines(jknn.main, _knn_args(folder, arch,
                                                            dump),
                                       "NN classifier"), np.load(dump))
        for dp in (0, 2):
            dump = str(out / f"torch_{arch}_{dp}.npz")
            argv = _knn_args(folder, arch, dump) + ["--device", "cpu"]
            if dp:
                argv += ["--dp", str(dp)]
            runs["torch", arch, dp] = (_lines(tknn.main, argv,
                                              "NN classifier"),
                                       np.load(dump))
    return runs


@pytest.mark.parametrize("arch", [VIT, RESNET])
def test_knn_cli_matches_tpu_ac(knn_runs, arch):
    jl, jd = knn_runs["jax", arch, 0]
    tl, td = knn_runs["torch", arch, 0]
    assert tl == jl and len(tl) == 2 and tl[0].startswith("3-NN")
    assert set(td.files) == set(jd.files)
    for key in ("train", "val"):
        np.testing.assert_allclose(td[key], jd[key], rtol=1e-5, atol=1e-5)
    for key in ("train_labels", "val_labels"):
        np.testing.assert_array_equal(td[key], jd[key])


@pytest.mark.parametrize("arch", [VIT, RESNET])
def test_knn_cli_dp_equals_plain(knn_runs, arch):
    pl, pd = knn_runs["torch", arch, 0]
    dl, dd = knn_runs["torch", arch, 2]
    assert dl == pl
    for key in ("train", "val"):
        np.testing.assert_allclose(dd[key], pd[key], rtol=1e-5, atol=1e-5)


def test_knn_cli_separates_the_classes(knn_runs):
    top1 = float(knn_runs["torch", VIT, 0][0][0].split("Top1:")[1]
                 .split(",")[0])
    assert top1 >= 75.0  # chance is 50


def test_knn_cli_dp_rejects_indivisible_batch(folder):
    with pytest.raises(ValueError, match="divisible"):
        tknn.main(["--arch", VIT, "--data_path", folder, "--imagesize",
                   "32", "--batch_size_per_gpu", "6", "--dp", "4",
                   "--device", "cpu"])


def test_cli_defaults_to_the_card(folder):
    """No --device: the CLIs ask for cuda and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (tknn.main, tlin.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--arch", VIT, "--data_path", folder])


def test_parsers_keep_tpu_ac_flags():
    for jmod, tmod in ((jknn, tknn), (jlin, tlin)):
        jp, tp = jmod.build_parser(), tmod.build_parser()
        jflags = {a.dest: a.default for a in jp._actions}
        tflags = {a.dest: a.default for a in tp._actions}
        assert tflags.pop("device") == "cuda"
        assert tflags == jflags


def _linear_args(folder, extra=()):
    return ["--arch", VIT, "--data_path", folder, "--n_last_blocks", "2",
            "--epochs", "3", "--lr", "0.05", "--batch_size_per_gpu", "4",
            "--imagesize", "32", *extra]


@pytest.mark.parametrize("extra", [(), ("--avgpool_patchtokens",)],
                         ids=["cls", "avgpool"])
def test_linear_cli_matches_tpu_ac(folder, extra):
    jl = _lines(jlin.main, _linear_args(folder, extra), "val top-1")
    tl = _lines(tlin.main, _linear_args(folder, extra) + ["--device", "cpu"],
                "val top-1")
    assert tl == jl and len(tl) == 2  # epochs 0 and 2


def test_linear_cli_dp_equals_plain(folder):
    plain = _lines(tlin.main, _linear_args(folder, ["--device", "cpu"]),
                   "val top-1")
    dp = _lines(tlin.main, _linear_args(folder, ["--device", "cpu", "--dp",
                                                 "2"]), "val top-1")
    assert dp == plain
    acc = float(plain[-1].split("val top-1")[1].split("%")[0])
    assert acc >= 75.0


def test_linear_cli_rejects_a_resnet(folder):
    with pytest.raises(SystemExit):
        tlin.main(["--arch", RESNET, "--data_path", folder, "--device",
                   "cpu"])


def test_knn_cli_missing_split_raises(tmp_path):
    empty = tmp_path / "no_splits"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tknn.main(["--arch", VIT, "--data_path", str(empty), "--imagesize",
                   "32", "--device", "cpu"])
