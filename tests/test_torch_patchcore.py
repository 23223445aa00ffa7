"""tpu_ac_torch.detect.PatchCore and tpu_ac_torch.cli.patchcore vs tpu_ac's
on the CPU.

PatchCore: a mean-pool embedder (a 4 x 4 grid of channel means) in each
package, fit/predict on seeded images: scores to 1e-5 relative, masks to
1e-5 of max|mask|, with the exact scorer, a coreset and the IVF scorers.

CLI: both CLIs on one synthetic MVTec tree (6 train, 12 test images at
64 px) with a tiny bottleneck ResNet registered under one name in both
registries, layer2 + layer3, patchsize 3, the default approximate greedy
coreset (10%) and k = 5, ``--compute_pro``, ``--save_segmentation_images``
(the same figure files).  The results.csv columns must
agree to 1e-3 absolute (a rank flip between two near-equal scores is
allowed); the port's images upload as uint8 and normalize on the device,
tpu_ac's normalize on the host, the same f32 arithmetic in both.  Saved
memory banks load across the packages (``--load_path``).
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac import detect as jdet
from tpu_ac.cli.patchcore import main as jax_cli
from tpu_ac.data import make_synthetic_mvtec
from tpu_ac.models import registry as jreg
from tpu_ac.models import resnet as jres
from tpu_ac_torch import detect as tdet
from tpu_ac_torch.cli.patchcore import main as torch_cli
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import resnet as tres

NAME = "tiny_patchcore_resnet"
CFG = dict(block_counts=(1, 1, 1, 1), num_classes=10)
COMMON = ["--backbone", NAME, "-le", "layer2", "-le", "layer3",
          "--pretrain_embed_dimension", "64", "--target_embed_dimension",
          "64", "--subdatasets", "bottle", "--resize", "72", "--imagesize",
          "64", "--batch_size", "4", "--compute_pro"]


def _jax_embed(images):
    b, c, h, w = images.shape
    x = np.asarray(images).reshape(b, c, 4, h // 4, 4, w // 4).mean(
        axis=(3, 5))
    return jnp.asarray(x.transpose(0, 2, 3, 1).reshape(b, 16, c))


def _torch_embed(images):
    b, c, h, w = images.shape
    x = images.float().reshape(b, c, 4, h // 4, 4, w // 4).mean(dim=(3, 5))
    return x.permute(0, 2, 3, 1).reshape(b, 16, c)


def _images(seed, n=6, shift=0.0):
    x = np.random.default_rng(seed).standard_normal((n, 3, 32, 32))
    return (x * 0.1 + shift).astype(np.float32)


@pytest.mark.parametrize("nn_method,sampler", [
    ("exact", None), ("exact", "coreset"), ("ivfflat", None),
    ("ivfpq", None)])
def test_patchcore_matches_tpu_ac(nn_method, sampler):
    train, test = _images(0), _images(1, n=5)
    test[3:] += 5.0  # anomalous
    out = {}
    for tag, mod, embed in (("jax", jdet, _jax_embed),
                            ("torch", tdet, _torch_embed)):
        kw = dict(target_size=(32, 32), batch_size=4, nn_method=nn_method,
                  anomaly_score_num_nn=2)
        if tag == "torch":
            kw["device"] = "cpu"
        if sampler:
            kw["featuresampler"] = mod.ApproximateGreedyCoresetSampler(
                0.5, dimension_to_project_features_to=3)
        pc = mod.PatchCore(embed, **kw)
        pc.fit(train)
        out[tag] = pc.predict(test)
    (js, jm), (ts, tm) = out["jax"], out["torch"]
    assert ts.shape == (5,) and tm.shape == (5, 32, 32)
    assert ts[3:].min() > ts[:3].max()
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5 * np.abs(jm).max())


def test_patchcore_keeps_the_bank_on_its_device(tmp_path):
    """The exact scorer receives the coreset as a tensor; save/load."""
    pc = tdet.PatchCore(_torch_embed, device="cpu", target_size=(32, 32),
                        batch_size=4, config={"backbone": "dummy"},
                        featuresampler=tdet.ApproximateGreedyCoresetSampler(
                            0.5, dimension_to_project_features_to=3))
    pc.fit(_images(2))
    bank = pc.anomaly_scorer.detection_features
    assert isinstance(bank, torch.Tensor) and tuple(bank.shape) == (48, 3)
    s1, m1 = pc.predict(_images(3, n=3))
    pc.save_to_path(str(tmp_path))
    pc2 = tdet.PatchCore(_torch_embed, device="cpu", target_size=(32, 32),
                         batch_size=4)
    pc2.load_from_path(str(tmp_path))
    s2, m2 = pc2.predict(_images(3, n=3))
    np.testing.assert_allclose(s1, s2)
    np.testing.assert_allclose(m1, m2)
    assert pc2.config == {"backbone": "dummy"}
    with pytest.raises(ValueError, match="mesh"):
        tdet.PatchCore(_torch_embed, nn_method="ivfpq", mesh=object(),
                       device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mvtec"))
    make_synthetic_mvtec(root, classname="bottle", image_size=64)
    jreg.register_backbone(NAME, jreg.BackboneSpec(
        "resnet", jres.ResNetConfig(**CFG), None))
    treg.register_backbone(NAME, treg.BackboneSpec(
        "resnet", tres.ResNetConfig(**CFG), None))
    outs = {}
    for tag, cli, extra in (("jax", jax_cli, []),
                            ("torch", torch_cli, ["--device", "cpu"])):
        out = str(tmp_path_factory.mktemp(tag))
        cli([out, "--data_path", root, *COMMON, "--save_patchcore_model",
             "--save_segmentation_images", *extra])
        outs[tag] = out
    return root, outs


def _csv(path):
    with open(os.path.join(path, "results.csv"), newline="") as f:
        return list(csv.DictReader(f))


def _assert_rows_agree(got, want):
    assert [r["dataset_name"] for r in got] == \
        [r["dataset_name"] for r in want] == ["mvtec_bottle", "Mean"]
    assert list(got[0]) == list(want[0]) == [
        "dataset_name", "instance_auroc", "full_pixel_auroc",
        "anomaly_pixel_auroc", "full_pro"]
    for g, w in zip(got, want):
        for key in list(g)[1:]:
            assert 0.0 <= float(g[key]) <= 1.0
            assert abs(float(g[key]) - float(w[key])) <= 1e-3, (key, g, w)


def test_results_csv_agrees(runs):
    _, outs = runs
    _assert_rows_agree(_csv(outs["torch"]), _csv(outs["jax"]))


def test_saved_banks_are_the_same_files(runs):
    _, outs = runs
    d = os.path.join("models", "bottle")
    files = sorted(os.listdir(os.path.join(outs["jax"], d)))
    assert files == sorted(os.listdir(os.path.join(outs["torch"], d))) == [
        f"{NAME}_nnscorer_memory_bank.npz", f"{NAME}_patchcore_params.json"]
    banks = [np.load(os.path.join(outs[t], d, files[0])) for t in outs]
    # 10% of 6 images x 64 patches
    assert banks[0]["bank"].shape == banks[1]["bank"].shape == (38, 64)
    assert int(banks[0]["k"]) == int(banks[1]["k"]) == 5
    np.testing.assert_allclose(banks[1]["bank"], banks[0]["bank"], rtol=0,
                               atol=1e-5 * np.abs(banks[0]["bank"]).max())


@pytest.mark.parametrize("direction", ["port_loads_jax", "jax_loads_port"])
def test_load_path_across_packages(runs, direction, tmp_path):
    root, outs = runs
    src, cli, extra = (("jax", torch_cli, ["--device", "cpu"])
                       if direction == "port_loads_jax"
                       else ("torch", jax_cli, []))
    cli([str(tmp_path), "--data_path", root, *COMMON, "--load_path",
         os.path.join(outs[src], "models"), *extra])
    _assert_rows_agree(_csv(str(tmp_path)), _csv(outs[src]))


def test_cli_defaults_to_cuda_and_refuses_segmentation_images(runs,
                                                              tmp_path):
    """The CLI defaults to cuda; --save_segmentation_images writes the
    same figures as tpu_ac's (both runs of ``runs`` pass it)."""
    root, outs = runs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_cli([str(tmp_path), "--data_path", root, *COMMON])
    d = os.path.join("segmentation_images", "bottle")
    names = sorted(os.listdir(os.path.join(outs["jax"], d)))
    assert sorted(os.listdir(os.path.join(outs["torch"], d))) == names
    assert names == [f"segmentation_{i:04d}.png" for i in range(12)]
