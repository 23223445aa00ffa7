"""tpu_ac_torch.models.resnetv2 vs tpu_ac on the CPU: the seeded init bit
for bit, every stage tap, the registry (seeded init and a timm-style
checkpoint in a default dir), and ``embed_features("resnetv2", ...)``.

Three layouts at block_counts (1, 1, 1, 1): BiT (pre-activation,
GroupNorm, weight-standardised convs, the "fixed" stem pool), timm's plain
resnetv2_101 (BatchNorm, ordinary convs, the standard stem pool) and the
hybrid's post-activation trunk (TF SAME padding everywhere, the "same"
stem pool, ws eps 1e-6), at 64 and 66 px (an odd half size, where SAME
pads asymmetrically).  Tolerance: 1e-5 of the largest |value| (both sides
compute in f32; convs and norms sum in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import resnetv2 as jrv2
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import resnetv2 as trv2

RTOL = 1e-5
FORMS = {
    "bit": dict(block_counts=(1, 1, 1, 1)),
    "plain_bn": dict(block_counts=(1, 1, 1, 1), norm="bn", std_conv=False,
                     stem_pool="standard"),
    "post_same": dict(block_counts=(1, 1, 1, 1), preact=False, tf_same=True,
                      stem_pool="same", ws_eps=1e-6),
}
TAPS = ("stage1", "stage2", "stage3", "stage4")


def _images(b=2, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _register(form: str, ckpt: str | None = None) -> str:
    name = f"tiny_resnetv2_{form}"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "resnetv2", jrv2.ResNetV2Config(**FORMS[form]), ckpt))
    treg.register_backbone(name, treg.BackboneSpec(
        "resnetv2", trv2.ResNetV2Config(**FORMS[form]), ckpt))
    return name


@pytest.mark.parametrize("form", ["resnetv2_101"] + sorted(FORMS))
def test_init_bit_identical(form):
    if form in FORMS:
        jcfg = jrv2.ResNetV2Config(**FORMS[form])
        tcfg = trv2.ResNetV2Config(**FORMS[form])
    else:
        jcfg = jreg.BACKBONE_CONFIGS[form].config
        tcfg = treg.BACKBONE_CONFIGS[form].config
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jrv2.init_resnetv2_params(3, jcfg)
    tp = trv2.init_resnetv2_params(3, tcfg)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("size", [64, 66])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_taps_match(form, size):
    name = _register(form)
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "resnetv2" and isinstance(model, trv2.ResNetV2)
    x = _images(size=size)
    want = jrv2.resnetv2_forward(jp, jnp.asarray(x), jcfg, taps=TAPS)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=TAPS)
    assert sorted(got) == sorted(TAPS)
    for t in TAPS:
        _close(got[t], want[t])


def test_forward_stops_after_deepest_tap():
    model, _, _ = treg.load_backbone(_register("bit"))
    with torch.no_grad():
        model.stages[2].blocks[0].conv1.weight.fill_(float("nan"))
        out = model(torch.from_numpy(_images()), taps=("stage2",))
    assert list(out) == ["stage2"]
    assert bool(torch.isfinite(out["stage2"]).all())


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """A timm-style .pth (a head.fc the trunk does not have) only in a
    default dir: both packages load it, with the same weights."""
    name = _register("bit", ckpt="tiny_bit.pth")
    params = trv2.init_resnetv2_params(9, trv2.ResNetV2Config(
        **FORMS["bit"]))
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["head.fc.weight"] = torch.zeros(10, 2048, 1, 1)
    torch.save(sd, tmp_path / "tiny_bit.pth")
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
def test_embed_features_resnetv2_matches(layernorm):
    """stage2 (8 x 8) + stage3 (4 x 4) of the BiT layout at 64 px."""
    name = _register("bit")
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("stage2", "stage3"), pretrain_embed_dimension=96,
              target_embed_dimension=80, apply_layernorm=layernorm)
    x = _images(seed=1)
    want = jemb.embed_features("resnetv2", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 64, 80)
    _close(got, want)
