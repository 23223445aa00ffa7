"""The timm ViT names of the registry (vit_small, vit_base, vit_large,
vit_deit_base, vit_deit_distilled) in tpu_ac_torch vs tpu_ac on the CPU:
the DeiT-distilled form (CLS + dist token) through
the taps, the embed (both prefix tokens dropped) and a timm-style
checkpoint in a default dir.

The distilled form at a tiny width (patch 8, width 32, depth 2, 2 heads,
32 and 48 px: the position embedding is resized past its two prefix
tokens).  Tolerance: 1e-5 of the largest |value| (both sides compute in
f32; matmuls sum in different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import vit as jvit
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import vit as tvit

RTOL = 1e-5
TIMM_VITS = ("vit_small", "vit_base", "vit_large", "vit_deit_base",
             "vit_deit_distilled")
DISTILLED = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2,
                 img_size=32, num_prefix_tokens=2)


def _images(b=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _register(ckpt: str | None = None) -> str:
    name = "tiny_deit_distilled"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "vit", jvit.ViTConfig(**DISTILLED), ckpt))
    treg.register_backbone(name, treg.BackboneSpec(
        "vit", tvit.ViTConfig(**DISTILLED), ckpt))
    return name


def test_the_timm_names_are_registered():
    """Their rows (config, filename) are held to tpu_ac's with every other
    name's in tests/test_torch_checkpoints.py."""
    for name in TIMM_VITS:
        assert treg.BACKBONE_CONFIGS[name].family == "vit"
        assert name in treg.BUILTIN_BACKBONES
    assert treg.BACKBONE_CONFIGS[
        "vit_deit_distilled"].config.num_prefix_tokens == 2


@pytest.mark.parametrize("size", [32, 48])
def test_distilled_taps_match(size):
    name = _register()
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, _ = treg.load_backbone(name)
    assert "dist_token" in model.state_dict()
    x = _images(size=size)
    want = jvit.vit_forward(jp, jnp.asarray(x), jcfg, taps=(0, 1))
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=(0, 1))
    for t in (0, 1):
        assert got[t].shape[1] == 2 + (size // 8) ** 2
        _close(got[t], want[t])


def test_distilled_checkpoint_in_default_dir_loads_like_tpu_ac(
        tmp_path, monkeypatch):
    """A timm DeiT-distilled .pth (dist_token, head and head_dist) only in
    a default dir: both packages load it, with the same weights."""
    name = _register(ckpt="tiny_deit.pth")
    params = tvit.init_vit_params(9, tvit.ViTConfig(**DISTILLED))
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["head.weight"] = torch.zeros(10, 32)
    sd["head_dist.weight"] = torch.zeros(10, 32)
    torch.save(sd, tmp_path / "tiny_deit.pth")
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
def test_distilled_embed_matches(layernorm):
    """blocks.0 + blocks.1 at 48 px: both prefix tokens dropped, a 6 x 6
    grid."""
    name = _register()
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("blocks.0", "blocks.1"), pretrain_embed_dimension=24,
              target_embed_dimension=48, apply_layernorm=layernorm)
    x = _images(size=48, seed=1)
    want = jemb.embed_features("vit", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 36, 48)
    _close(got, want)
