"""tpu_ac_torch.models.xcit vs tpu_ac on the CPU: the seeded init bit for
bit, the positional encoding, every tapped XCA block and the CLS feature
(class-attention blocks included), the registry (seeded init and a DINO
checkpoint in a default dir), and ``embed_features("xcit", ...)``.

tpu_ac's TINY XCiT (tests/test_xcit.py: patch 8, width 32, depth 3, 4
heads, 2 class-attention blocks) at 32 px and at 48 px (a 6 x 6 grid),
plus the p16 patch embedding (four conv stages).  Tolerance: 1e-5 of the
largest |value| (both sides compute in f32; matmuls sum in different
orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import xcit as jx
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import xcit as tx

RTOL = 1e-5
FORMS = {"tiny": dict(patch_size=8, embed_dim=32, depth=3, num_heads=4,
                      cls_attn_layers=2),
         "tiny_p16": dict(patch_size=16, embed_dim=32, depth=2, num_heads=4,
                          cls_attn_layers=1, tokens_norm=False)}


def _images(b=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _register(form: str, ckpt: str | None = None) -> str:
    name = f"tiny_xcit_{form}"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "xcit", jx.XCiTConfig(**FORMS[form]), ckpt))
    treg.register_backbone(name, treg.BackboneSpec(
        "xcit", tx.XCiTConfig(**FORMS[form]), ckpt))
    return name


@pytest.mark.parametrize("form", ["dino_xcit_small_12_p16"] + sorted(FORMS))
def test_init_bit_identical(form):
    if form in FORMS:
        jcfg, tcfg = jx.XCiTConfig(**FORMS[form]), tx.XCiTConfig(**FORMS[form])
    else:
        jcfg = jreg.BACKBONE_CONFIGS[form].config
        tcfg = treg.BACKBONE_CONFIGS[form].config
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jx.init_xcit_params(3, jcfg)
    tp = tx.init_xcit_params(3, tcfg)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


def test_positional_encoding_matches():
    name = _register("tiny")
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, _ = treg.load_backbone(name)
    with torch.no_grad():
        got = model.positional_encoding(5, 7, "cpu")
    _close(got, jx.positional_encoding_fourier(jp, 5, 7, jcfg))


@pytest.mark.parametrize("form,size", [("tiny", 32), ("tiny", 48),
                                       ("tiny_p16", 64)])
def test_taps_and_cls_match(form, size):
    name = _register(form)
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "xcit" and isinstance(model, tx.XCiT)
    # non-trivial per-head temperatures
    temp = {k: np.linspace(0.5, 2.0, v.size, dtype=np.float32).reshape(
        v.shape) for k, v in jp.items() if k.endswith("attn.temperature")}
    jp = {**jp, **{k: jnp.asarray(v) for k, v in temp.items()}}
    with torch.no_grad():
        for k, v in temp.items():
            model.get_parameter(k).copy_(torch.from_numpy(v))
    x = _images(size=size)
    taps = tuple(range(jcfg.depth))
    want = jx.xcit_forward(jp, jnp.asarray(x), jcfg, taps=taps)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=taps)
        cls = tx.xcit_cls_forward(model, torch.from_numpy(x))
    assert sorted(got) == sorted(taps)
    for t in taps:
        assert got[t].shape[1] == (size // jcfg.patch_size) ** 2
        _close(got[t], want[t])
    _close(cls, jx.xcit_cls_forward(jp, jnp.asarray(x), jcfg))


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """A DINO training checkpoint of an XCiT (teacher sub-dict, backbone.
    prefix, a head) only in a default dir: both packages load it, with the
    same weights."""
    jreg.register_backbone("tiny_xcit_ckpt", jreg.BackboneSpec(
        "xcit", jx.XCiTConfig(**FORMS["tiny"]), "tiny_xcit.pth", "teacher"))
    treg.register_backbone("tiny_xcit_ckpt", treg.BackboneSpec(
        "xcit", tx.XCiTConfig(**FORMS["tiny"]), "tiny_xcit.pth", "teacher"))
    params = tx.init_xcit_params(9, tx.XCiTConfig(**FORMS["tiny"]))
    sd = {"backbone." + k: torch.from_numpy(v.copy())
          for k, v in params.items()}
    sd["head.last_layer.weight"] = torch.zeros(10, 32)
    torch.save({"teacher": sd, "epoch": 3}, tmp_path / "tiny_xcit.pth")
    monkeypatch.setattr(jreg, "_DEFAULT_CKPT_DIRS", (str(tmp_path),))
    monkeypatch.setattr(treg, "_DEFAULT_CKPT_DIRS", (str(tmp_path),))
    jp, _, _ = jreg.load_backbone("tiny_xcit_ckpt")
    model, _, _ = treg.load_backbone("tiny_xcit_ckpt")
    state = model.state_dict()
    assert sorted(state) == sorted(params)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), params[k], err_msg=k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[k]),
                                      err_msg=k)


@pytest.mark.parametrize("layernorm", [False, True])
def test_embed_features_xcit_matches(layernorm):
    """blocks.1 + blocks.2 at 48 px: 36 tokens (no CLS) onto a 6 x 6
    grid."""
    name = _register("tiny")
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("blocks.1", "blocks.2"), pretrain_embed_dimension=48,
              target_embed_dimension=40, apply_layernorm=layernorm)
    x = _images(size=48, seed=1)
    want = jemb.embed_features("xcit", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 36, 40)
    _close(got, want)
