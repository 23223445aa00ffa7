"""tpu_ac_torch.models.resnet and the ResNet family's embed vs tpu_ac on the
CPU: the seeded init bit for bit, the tapped stages and the logits, the
registry (seeded init and a torchvision-style checkpoint in a default
dir), and ``features.embedding.embed_features("resnet", ...)``.

Tiny configs, registered under one name in both registries: block_counts
(1, 1, 1, 1) in the basic, bottleneck, wide and grouped (ResNeXt) forms,
at 48 px.  Tolerance: 1e-5 of the largest |value| (both sides compute in
f32; convs and BN sum in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import resnet as jres
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import resnet as tres

FORMS = {
    "basic": dict(block_counts=(1, 1, 1, 1), expansion=1, block="basic",
                  num_classes=10),
    "bottleneck": dict(block_counts=(1, 1, 1, 1), num_classes=10),
    "wide": dict(block_counts=(1, 1, 1, 1), width_per_group=128,
                 num_classes=10),
    "groups": dict(block_counts=(1, 1, 1, 1), groups=4, width_per_group=8,
                   num_classes=10),
}
RTOL = 1e-5


def _register(form: str, ckpt: str | None = None) -> str:
    name = f"tiny_resnet_{form}"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "resnet", jres.ResNetConfig(**FORMS[form]), ckpt))
    treg.register_backbone(name, treg.BackboneSpec(
        "resnet", tres.ResNetConfig(**FORMS[form]), ckpt))
    return name


def _images(b=2, size=48, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("form", sorted(FORMS))
def test_init_bit_identical(form):
    jp = jres.init_resnet_params(3, jres.ResNetConfig(**FORMS[form]))
    tp = tres.init_resnet_params(3, tres.ResNetConfig(**FORMS[form]))
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_taps_and_logits_match(form):
    name = _register(form)
    jp, jcfg, _ = jreg.load_backbone(name)
    model, tcfg, family = treg.load_backbone(name)
    assert family == "resnet" and isinstance(model, tres.ResNet)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    x = _images()
    taps = ("layer1", "layer2", "layer3", "layer4")
    want = jres.resnet_forward(jp, jnp.asarray(x), jcfg, taps=taps)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=taps)
        logits = tres.resnet_classify(model, torch.from_numpy(x))
    assert sorted(got) == sorted(taps)
    for t in taps:
        _close(got[t], want[t])
    _close(logits, jres.resnet_classify(jp, jnp.asarray(x), jcfg))


def test_forward_stops_after_deepest_tap():
    name = _register("basic")
    model, _, _ = treg.load_backbone(name)
    # layer3 never runs: its weights may be garbage
    with torch.no_grad():
        model.layer3[0].conv1.weight.fill_(float("nan"))
        out = model(torch.from_numpy(_images()), taps=("layer2",))
    assert list(out) == ["layer2"]
    assert bool(torch.isfinite(out["layer2"]).all())


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """A torchvision-style .pth (BN counters, fc) only in a default dir:
    both packages load it, with the same weights."""
    name = _register("bottleneck", ckpt="tiny_resnet.pth")
    params = tres.init_resnet_params(9, tres.ResNetConfig(**FORMS[
        "bottleneck"]))
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "tiny_resnet.pth")
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
def test_embed_features_resnet_matches(layernorm):
    """layer2 (12 x 12) + layer3 (6 x 6, bilinear-aligned after the pool)
    at 96 px, patchsize 3: PatchCore (raw) and clustering (LayerNorm)."""
    name = _register("wide")
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("layer2", "layer3"), pretrain_embed_dimension=96,
              target_embed_dimension=80, apply_layernorm=layernorm)
    x = _images(size=96, seed=1)
    want = jemb.embed_features("resnet", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 144, 80)
    _close(got, want)


def test_unported_family_raises():
    """A family in neither table (every registry family is ported: a
    made-up one stands in) raises in the embed and in the registry."""
    with pytest.raises(NotImplementedError, match="family 'made_up'"):
        temb.embed_features("made_up", None, None, temb.EmbedConfig())
    treg.register_backbone("tiny_made_up_stub", treg.BackboneSpec(
        "made_up", None, None))
    with pytest.raises(NotImplementedError, match="family 'made_up' is "
                                                  "not ported"):
        treg.load_backbone("tiny_made_up_stub")
