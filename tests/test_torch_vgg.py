"""tpu_ac_torch.models.vgg (VGG and AlexNet) vs tpu_ac on the CPU: the
seeded init bit for bit, every tap, the registry (seeded init and a
torchvision-style checkpoint in a default dir), and
``embed_features("vgg" | "alexnet", ...)``.

VGG at vgg11's layout with and without BN, at 48 px; AlexNet at its only
(full) config, at 96 px.  Tolerance: 1e-5 of the largest |value| (both
sides compute in f32; convs sum in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import vgg as jvgg
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import vgg as tvgg

RTOL = 1e-5
FORMS = {"vgg11": dict(arch="vgg11"),
         "vgg11_bn": dict(arch="vgg11", batch_norm=True)}


def _images(b=2, size=48, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _register(form: str, ckpt: str | None = None) -> str:
    """A VGG form, or "alexnet", under one name in both registries."""
    name = f"tiny_{form}"
    if form == "alexnet":
        jspec = jreg.BackboneSpec("alexnet", jvgg.ALEXNET, ckpt)
        tspec = treg.BackboneSpec("alexnet", tvgg.ALEXNET, ckpt)
    else:
        jspec = jreg.BackboneSpec("vgg", jvgg.VGGConfig(**FORMS[form]), ckpt)
        tspec = treg.BackboneSpec("vgg", tvgg.VGGConfig(**FORMS[form]), ckpt)
    jreg.register_backbone(name, jspec)
    treg.register_backbone(name, tspec)
    return name


@pytest.mark.parametrize("name", ["vgg11", "vgg19_bn", "alexnet"])
def test_init_bit_identical(name):
    jspec, tspec = jreg.BACKBONE_CONFIGS[name], treg.BACKBONE_CONFIGS[name]
    assert dataclasses.asdict(tspec.config) == \
        dataclasses.asdict(jspec.config)
    init = "init_alexnet_params" if name == "alexnet" else "init_vgg_params"
    jp = getattr(jvgg, init)(3, jspec.config)
    tp = getattr(tvgg, init)(3, tspec.config)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_vgg_taps_match(form):
    name = _register(form)
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "vgg" and isinstance(model, tvgg.VGG)
    x = _images()
    taps = ("stage1", "stage2", "stage3", "stage4", "stage5")
    want = jvgg.vgg_forward(jp, jnp.asarray(x), jcfg, taps=taps)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=taps)
    assert sorted(got) == sorted(taps)
    for t in taps:
        _close(got[t], want[t])


def test_alexnet_taps_match():
    name = _register("alexnet")
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "alexnet" and isinstance(model, tvgg.AlexNet)
    x = _images(size=96)
    taps = ("conv1", "conv2", "conv3", "conv4", "conv5")
    want = jvgg.alexnet_forward(jp, jnp.asarray(x), jcfg, taps=taps)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=taps)
    assert sorted(got) == sorted(taps)
    for t in taps:
        _close(got[t], want[t])


def test_forward_stops_after_deepest_tap():
    name = _register("vgg11")
    model, _, _ = treg.load_backbone(name)
    with torch.no_grad():
        model.features[6].weight.fill_(float("nan"))  # stage3's first conv
        out = model(torch.from_numpy(_images()), taps=("stage2",))
    assert list(out) == ["stage2"]
    assert bool(torch.isfinite(out["stage2"]).all())


@pytest.mark.parametrize("form", ["vgg11_bn", "alexnet"])
def test_checkpoint_in_default_dir_loads_like_tpu_ac(form, tmp_path,
                                                     monkeypatch):
    """A torchvision-style .pth (BN counters, a classifier) only in a
    default dir: both packages load it, with the same weights."""
    name = _register(form, ckpt="tiny_vgg.pth")
    cfg = treg.BACKBONE_CONFIGS[name].config
    init = tvgg.init_alexnet_params if form == "alexnet" \
        else tvgg.init_vgg_params
    params = init(9, cfg)
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["classifier.6.weight"] = torch.zeros(10, 4)
    if form == "vgg11_bn":
        sd["features.1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "tiny_vgg.pth")
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


@pytest.mark.parametrize("form,layers,size", [
    ("vgg11_bn", ("stage3", "stage4"), 64),
    ("alexnet", ("conv2", "conv5"), 128)])
@pytest.mark.parametrize("layernorm", [False, True])
def test_embed_features_matches(form, layers, size, layernorm):
    """Two taps a factor 2 apart (bilinear-aligned after the pool), the
    clustering (LayerNorm) and PatchCore (raw) tails."""
    name = _register(form)
    jp, jcfg, family = jreg.load_backbone(name)
    model, _, _ = treg.load_backbone(name)
    kw = dict(layers=layers, pretrain_embed_dimension=96,
              target_embed_dimension=80, apply_layernorm=layernorm)
    x = _images(size=size, seed=1)
    want = jemb.embed_features(family, jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert got.shape[-1] == 80
    _close(got, want)
