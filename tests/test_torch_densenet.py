"""tpu_ac_torch.models.densenet vs tpu_ac on the CPU: the seeded init bit
for bit, every dense-block tap, the registry (seeded init, and a
torchvision DenseNet ``.pth`` with the legacy ``norm.1`` / ``conv.2`` keys
in a default dir), and ``embed_features("densenet", ...)``.

A reduced config (block_config (2, 2, 2, 2), growth 8, 16 stem
features) at 64 px.  Tolerance: 1e-5 of the largest |value| (both sides
compute in f32; convs sum in different orders).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import densenet as jdn
from tpu_ac.models import registry as jreg
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import densenet as tdn
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models.convert import remap_densenet_keys

RTOL = 1e-5
CFG = dict(block_config=(2, 2, 2, 2), growth_rate=8, num_init_features=16,
           num_classes=10)
TAPS = ("denseblock1", "denseblock2", "denseblock3", "denseblock4")


def _images(b=2, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _register(ckpt: str | None = None) -> str:
    name = "tiny_densenet"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "densenet", jdn.DenseNetConfig(**CFG), ckpt))
    treg.register_backbone(name, treg.BackboneSpec(
        "densenet", tdn.DenseNetConfig(**CFG), ckpt))
    return name


@pytest.mark.parametrize("name", ["densenet121", "tiny"])
def test_init_bit_identical(name):
    if name == "tiny":
        jcfg, tcfg = jdn.DenseNetConfig(**CFG), tdn.DenseNetConfig(**CFG)
    else:
        jcfg = jreg.BACKBONE_CONFIGS[name].config
        tcfg = treg.BACKBONE_CONFIGS[name].config
    jp = jdn.init_densenet_params(3, jcfg)
    tp = tdn.init_densenet_params(3, tcfg)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


def test_taps_match():
    name = _register()
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "densenet" and isinstance(model, tdn.DenseNet)
    x = _images()
    want = jdn.densenet_forward(jp, jnp.asarray(x), jcfg, taps=TAPS)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=TAPS)
    assert sorted(got) == sorted(TAPS)
    for t in TAPS:
        _close(got[t], want[t])


def test_forward_stops_after_deepest_tap():
    model, _, _ = treg.load_backbone(_register())
    with torch.no_grad():
        model.features.transition2.conv.weight.fill_(float("nan"))
        out = model(torch.from_numpy(_images()), taps=("denseblock2",))
    assert list(out) == ["denseblock2"]
    assert bool(torch.isfinite(out["denseblock2"]).all())


def _legacy(key: str) -> str:
    """torchvision's spelling in its released files: norm1 -> norm.1."""
    return re.sub(r"(denselayer\d+\.(?:norm|conv))([12])\.", r"\1.\2.", key)


def test_remap_densenet_keys_matches_tpu_ac():
    from tpu_ac.models.convert import remap_densenet_keys as jremap

    keys = [_legacy(k) for k in tdn.init_densenet_params(
        0, tdn.DenseNetConfig(**CFG))]
    assert any(".norm.1." in k for k in keys)
    sd = {k: i for i, k in enumerate(keys)}
    assert remap_densenet_keys(sd) == jremap(sd)


def test_torchvision_checkpoint_in_default_dir_loads_like_tpu_ac(
        tmp_path, monkeypatch):
    """A torchvision DenseNet .pth (legacy dense-layer keys, BN counters)
    only in a default dir: both packages load it, with the same weights;
    without the remap its dense layers would be missing."""
    name = _register(ckpt="tiny_densenet.pth")
    params = tdn.init_densenet_params(9, tdn.DenseNetConfig(**CFG))
    sd = {_legacy(k): torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["features.norm0.num_batches_tracked"] = torch.tensor(7)
    sd[_legacy("features.denseblock1.denselayer1.norm1.num_batches_tracked"
               )] = torch.tensor(7)
    assert "features.denseblock1.denselayer1.norm.1.weight" in sd
    torch.save(sd, tmp_path / "tiny_densenet.pth")
    monkeypatch.setattr(jreg, "_DEFAULT_CKPT_DIRS", (str(tmp_path),))
    monkeypatch.setattr(treg, "_DEFAULT_CKPT_DIRS", (str(tmp_path),))
    jp, _, _ = jreg.load_backbone(name)
    model, _, _ = treg.load_backbone(name)
    state = model.state_dict()
    assert sorted(state) == sorted(params)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), params[k], err_msg=k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[k]),
                                      err_msg=k)


@pytest.mark.parametrize("layernorm", [False, True])
def test_embed_features_densenet_matches(layernorm):
    """denseblock2 (16 x 16) + denseblock3 (8 x 8) at 128 px."""
    name = _register()
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("denseblock2", "denseblock3"),
              pretrain_embed_dimension=96, target_embed_dimension=80,
              apply_layernorm=layernorm)
    x = _images(size=128, seed=1)
    want = jemb.embed_features("densenet", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 256, 80)
    _close(got, want)
