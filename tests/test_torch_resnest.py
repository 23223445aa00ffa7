"""tpu_ac_torch.models.resnest vs tpu_ac on the CPU: the seeded init bit
for bit, every stage tap, the split-attention gate, the registry (seeded
init and a timm-style checkpoint in a default dir), and
``embed_features("resnest", ...)``.

resnest50d_4s2x40d's blocks (radix 4, cardinality 2, width 40, avd
first) at block_counts (1, 1, 1, 1), and the radix-1 (sigmoid gate),
pool-after variant, at 64 px.  Tolerance: 1e-5 of the largest |value|
(both sides compute in f32; convs sum in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import resnest as jrst
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import resnest as trst

RTOL = 1e-5
FORMS = {"4s2x40d": dict(block_counts=(1, 1, 1, 1)),
         "radix1_after": dict(block_counts=(1, 1, 1, 1), radix=1,
                              avd_first=False)}
TAPS = ("layer1", "layer2", "layer3", "layer4")


def _images(b=2, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _register(form: str, ckpt: str | None = None) -> str:
    name = f"tiny_resnest_{form}"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "resnest", jrst.ResNeStConfig(**FORMS[form]), ckpt))
    treg.register_backbone(name, treg.BackboneSpec(
        "resnest", trst.ResNeStConfig(**FORMS[form]), ckpt))
    return name


@pytest.mark.parametrize("form", ["resnest50"] + sorted(FORMS))
def test_init_bit_identical(form):
    if form == "resnest50":
        jcfg = jreg.BACKBONE_CONFIGS[form].config
        tcfg = treg.BACKBONE_CONFIGS[form].config
    else:
        jcfg = jrst.ResNeStConfig(**FORMS[form])
        tcfg = trst.ResNeStConfig(**FORMS[form])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jrst.init_resnest_params(3, jcfg)
    tp = trst.init_resnest_params(3, tcfg)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("radix,card", [(4, 2), (2, 1), (1, 2)])
def test_rsoftmax_matches(radix, card):
    x = np.random.default_rng(5).standard_normal(
        (3, radix * card * 6)).astype(np.float32)
    want = jrst._rsoftmax(jnp.asarray(x), radix, card)
    got = trst._rsoftmax(torch.from_numpy(x), radix, card)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_taps_match(form):
    name = _register(form)
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "resnest" and isinstance(model, trst.ResNeSt)
    # non-trivial gates: fc2 biases that favour one radix split
    rng = np.random.default_rng(7)
    params = {k: np.asarray(v) for k, v in jp.items()}
    for k in params:
        if k.endswith("conv2.fc2.bias"):
            params[k] = rng.standard_normal(params[k].shape).astype(
                np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in params.items()})
    x = _images()
    want = jrst.resnest_forward(jp, jnp.asarray(x), jcfg, taps=TAPS)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=TAPS)
    assert sorted(got) == sorted(TAPS)
    for t in TAPS:
        _close(got[t], want[t])


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """A timm-style .pth (BN counters, an fc head) only in a default dir:
    both packages load it, with the same weights."""
    name = _register("4s2x40d", ckpt="tiny_resnest.pth")
    params = trst.init_resnest_params(9, trst.ResNeStConfig(
        **FORMS["4s2x40d"]))
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["bn1.num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"] = torch.zeros(10, 2048)
    torch.save(sd, tmp_path / "tiny_resnest.pth")
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
def test_embed_features_resnest_matches(layernorm):
    """layer2 (8 x 8) + layer3 (4 x 4) at 64 px."""
    name = _register("4s2x40d")
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("layer2", "layer3"), pretrain_embed_dimension=96,
              target_embed_dimension=80, apply_layernorm=layernorm)
    x = _images(seed=1)
    want = jemb.embed_features("resnest", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 64, 80)
    _close(got, want)
