"""Checkpoints in tpu_ac_torch vs tpu_ac on the CPU: the registry's search
of the default cache dirs and its checkpoint formats, the convert CLI's
verify and install, the frozen manifests, and the hub factories.

The default dirs are monkeypatched in both packages (``_DEFAULT_CKPT_DIRS``
is computed at import), never ``$HOME``.  Every ``.pth`` is made here with
``torch.save`` of a seeded init; weights are compared exactly (both sides
copy the same f32 arrays).
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

from tpu_ac import hub as jhub
from tpu_ac.cli.convert import main as jax_convert
from tpu_ac.models import manifest as jman
from tpu_ac.models import registry as jreg
from tpu_ac.models import vit as jvit
from tpu_ac_torch import hub as thub
from tpu_ac_torch.cli.convert import main as torch_convert
from tpu_ac_torch.models import manifest as tman
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_torch_checkpoint

CFG = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
NAME = "tiny_ckpt_test"
FILE = "tiny_ckpt_test.pth"
# every built-in name of tpu_ac's registry: 56, in 15 families
BUILTIN_NAMES = tuple(sorted(jreg.BUILTIN_BACKBONES))


@pytest.fixture(scope="module")
def weights():
    """A seeded init other than the registry's seed-0 fallback."""
    return tvit.init_vit_params(7, tvit.ViTConfig(**CFG))


@pytest.fixture
def default_dir(tmp_path, monkeypatch):
    """The tiny backbone in both registries, one empty default dir."""
    jreg.register_backbone(NAME, jreg.BackboneSpec(
        "vit", jvit.ViTConfig(**CFG), FILE))
    treg.register_backbone(NAME, treg.BackboneSpec(
        "vit", tvit.ViTConfig(**CFG), FILE))
    d = tmp_path / "hub_checkpoints"
    d.mkdir()
    monkeypatch.setattr(jreg, "_DEFAULT_CKPT_DIRS", (str(d),))
    monkeypatch.setattr(treg, "_DEFAULT_CKPT_DIRS", (str(d),))
    return d


def _wild(weights):
    """The state_dict as a DDP run saves it, with an unused head."""
    sd = {"module." + k: torch.from_numpy(v.copy())
          for k, v in weights.items()}
    sd["module.head.weight"] = torch.zeros(10, 64)
    return sd


def _assert_same_weights(port_model, jax_params, weights):
    sd = port_model.state_dict()
    assert sorted(sd) == sorted(weights)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jax_params[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(v.numpy(), weights[k], err_msg=k)


def test_default_dir_loads_like_tpu_ac(default_dir, weights):
    """A .pth with a module. prefix and an extra tensor, only in a default
    dir (the torch.hub cache, where the reference keeps its weights): both
    packages load it, with the same weights."""
    torch.save(_wild(weights), default_dir / FILE)
    jp, _, _ = jreg.load_backbone(NAME)
    model, cfg, family = treg.load_backbone(NAME)
    assert family == "vit" and cfg == tvit.ViTConfig(**CFG)
    _assert_same_weights(model, jp, weights)


@pytest.mark.parametrize("wrap", ["teacher", "state_dict", "training"])
def test_checkpoint_formats(default_dir, weights, wrap):
    """checkpoint_key sub-dicts, state_dict wrappers, and a full training
    checkpoint whose non-tensor entries defeat weights_only=True."""
    sd = _wild(weights)
    if wrap == "state_dict":
        ckpt, key = {"state_dict": sd}, None
    elif wrap == "teacher":
        ckpt, key = {"teacher": sd, "student": {}}, "teacher"
    else:
        ckpt, key = {"teacher": sd, "epoch": 3,
                     "args": argparse.Namespace(lr=0.1)}, "teacher"
    jreg.register_backbone(NAME, jreg.BackboneSpec(
        "vit", jvit.ViTConfig(**CFG), FILE, key))
    treg.register_backbone(NAME, treg.BackboneSpec(
        "vit", tvit.ViTConfig(**CFG), FILE, key))
    path = default_dir / FILE
    torch.save(ckpt, path)
    jp, _, _ = jreg.load_backbone(NAME)
    model, _, _ = treg.load_backbone(NAME)
    _assert_same_weights(model, jp, weights)
    # an explicit checkpoint_path takes precedence over the search
    model, _, _ = treg.load_backbone(NAME, checkpoint_path=str(path),
                                     checkpoint_dir="/nonexistent")
    _assert_same_weights(model, jp, weights)


def test_checkpoint_dir_before_default_dirs(default_dir, weights, tmp_path):
    own = tmp_path / "own"
    own.mkdir()
    torch.save(_wild(weights), own / FILE)
    torch.save(_wild(tvit.init_vit_params(8, tvit.ViTConfig(**CFG))),
               default_dir / FILE)
    model, _, _ = treg.load_backbone(NAME, checkpoint_dir=str(own))
    np.testing.assert_array_equal(model.pos_embed.numpy(),
                                  weights["pos_embed"])
    # use_checkpoint=False ignores both files: the seeded init
    model, _, _ = treg.load_backbone(NAME, checkpoint_dir=str(own), seed=3,
                                     use_checkpoint=False)
    np.testing.assert_array_equal(
        model.pos_embed.numpy(),
        tvit.init_vit_params(3, tvit.ViTConfig(**CFG))["pos_embed"])


def test_missing_or_misshaped_key_raises(default_dir, weights):
    sd = _wild(weights)
    del sd["module.blocks.1.mlp.fc2.bias"]
    torch.save(sd, default_dir / FILE)
    with pytest.raises(KeyError, match="missing"):
        treg.load_backbone(NAME)
    sd = _wild(weights)
    sd["module.cls_token"] = torch.zeros(1, 1, 32)
    torch.save(sd, default_dir / FILE)
    with pytest.raises(ValueError, match="shape"):
        treg.load_backbone(NAME)


def test_num_batches_tracked_dropped(tmp_path):
    path = tmp_path / "bn.pth"
    torch.save({"module.bn.weight": torch.ones(3),
                "module.bn.num_batches_tracked": torch.tensor(5)}, path)
    params = load_torch_checkpoint(str(path))
    assert list(params) == ["bn.weight"]
    assert isinstance(params["bn.weight"], np.ndarray)


@pytest.fixture(scope="module")
def deitsmall_checkpoint(tmp_path_factory):
    """A full training checkpoint of dino_deitsmall16 (the smallest
    built-in name) in the wild shape: prefixes, an extra head, a sub-dict
    key and a non-tensor entry."""
    params = tvit.init_vit_params(11, treg.BACKBONE_CONFIGS[
        "dino_deitsmall16"].config)
    sd = {"module." + k: torch.from_numpy(v) for k, v in params.items()}
    sd["module.head.weight"] = torch.zeros(10, 384)
    path = tmp_path_factory.mktemp("ckpt") / "train.pth"
    torch.save({"teacher": sd, "args": argparse.Namespace(lr=0.1)},
               str(path))
    return str(path)


def test_convert_cli_matches_tpu_ac(deitsmall_checkpoint, tmp_path, capsys):
    """--verify reports are equal and the --install files hold equal keys
    and tensors; the port's install then loads through load_backbone."""
    reports, files = {}, {}
    for tag, convert in (("jax", jax_convert), ("torch", torch_convert)):
        cache = str(tmp_path / tag)
        reports[tag] = convert([deitsmall_checkpoint, "--backbone",
                                "dino_deitsmall16", "--checkpoint_key",
                                "teacher", "--verify", "--install",
                                "--cache_dir", cache])
        files[tag] = torch.load(os.path.join(
            cache, "dino_deitsmall16_pretrain.pth"), weights_only=True)
    assert "VERIFIED" in capsys.readouterr().out
    assert reports["torch"] == reports["jax"]
    assert reports["torch"]["unexpected"] == ["head.weight"]
    assert not reports["torch"]["missing"]
    assert sorted(files["torch"]) == sorted(files["jax"])
    for k, v in files["jax"].items():
        assert torch.equal(files["torch"][k], v), k
    model, _, _ = treg.load_backbone("dino_deitsmall16",
                                     checkpoint_dir=str(tmp_path / "torch"))
    want = files["jax"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_convert_cli_refuses_wrong_backbone(deitsmall_checkpoint, tmp_path):
    cache = tmp_path / "cache"
    with pytest.raises(SystemExit):
        torch_convert([deitsmall_checkpoint, "--backbone", "dino_vitbase16",
                       "--checkpoint_key", "teacher", "--verify",
                       "--cache_dir", str(cache)])
    with pytest.raises(SystemExit):
        torch_convert([deitsmall_checkpoint, "--backbone", "dino_vitbase16",
                       "--checkpoint_key", "teacher", "--install",
                       "--cache_dir", str(cache)])
    assert not cache.exists()


@pytest.mark.parametrize("name", BUILTIN_NAMES)
def test_registry_rows_equal_tpu_ac(name):
    """The same family, config, filename and checkpoint key per name."""
    jspec, tspec = jreg.BACKBONE_CONFIGS[name], treg.BACKBONE_CONFIGS[name]
    assert dataclasses.asdict(tspec.config) == \
        dataclasses.asdict(jspec.config)
    assert (tspec.family, tspec.checkpoint, tspec.checkpoint_key) == \
        (jspec.family, jspec.checkpoint, jspec.checkpoint_key)
    assert tspec.family in treg.FAMILY_MODELS


@pytest.mark.parametrize("name", BUILTIN_NAMES)
def test_manifest_entries_equal_tpu_ac(name):
    assert tman.load_manifests()[name] == jman.load_manifests()[name]


def test_manifest_covers_the_builtin_names():
    frozen = tman.load_manifests()
    assert sorted(frozen) == sorted(treg.BUILTIN_BACKBONES) == \
        list(BUILTIN_NAMES)
    assert len(BUILTIN_NAMES) == 56
    assert len(frozen["dino_vitbase8"]) == 150
    assert len(frozen["wideresnet50"]) == 267
    assert NAME not in treg.BUILTIN_BACKBONES


@pytest.mark.parametrize("name", BUILTIN_NAMES)
def test_generated_manifest_equals_frozen(name):
    """No drift: the architecture's inventory (its module built on the
    meta device, so the 0.9 G-parameter names cost nothing) equals the
    frozen one."""
    assert tman.generate_manifest(name) == tman.load_manifests()[name]


def test_diff_inventory_matches_tpu_ac():
    expected = {"a": [2, 3], "b": [4], "c": [1]}
    got = {"a": [2, 3], "b": [5], "d": [7]}
    assert tman.diff_inventory(expected, got) == \
        jman.diff_inventory(expected, got) == {
            "missing": ["c"], "unexpected": ["d"],
            "shape_mismatch": [("b", [4], [5])]}
    with pytest.raises(KeyError, match="manifest"):
        tman.verify_checkpoint({}, NAME)


@pytest.mark.parametrize("factory", ["dino_vits16", "dino_vits8",
                                     "dino_vitb16", "dino_vitb8",
                                     "dino_resnet50", "wide_resnet50_2",
                                     "dino_xcit_small_12_p16",
                                     "dino_xcit_small_12_p8",
                                     "dino_xcit_medium_24_p16",
                                     "dino_xcit_medium_24_p8"])
def test_hub_factories_match_tpu_ac(monkeypatch, factory):
    """Each factory names the same registry entry as tpu_ac.hub's, and the
    two registries hold the same config and filename for it."""
    calls = {}
    monkeypatch.setattr(jhub, "load_backbone",
                        lambda name, **kw: calls.setdefault("jax", name))
    monkeypatch.setattr(thub, "load_backbone",
                        lambda name, **kw: calls.setdefault("torch", name))
    getattr(jhub, factory)()
    getattr(thub, factory)()
    name = calls["torch"]
    assert name == calls["jax"]
    jspec, tspec = jreg.BACKBONE_CONFIGS[name], treg.BACKBONE_CONFIGS[name]
    assert dataclasses.asdict(tspec.config) == \
        dataclasses.asdict(jspec.config)
    assert (tspec.family, tspec.checkpoint, tspec.checkpoint_key) == \
        (jspec.family, jspec.checkpoint, jspec.checkpoint_key)
