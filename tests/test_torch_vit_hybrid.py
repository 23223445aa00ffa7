"""tpu_ac_torch.models.vit_hybrid (R50+ViT) vs tpu_ac on the CPU: the
seeded init bit for bit, the tapped blocks and the CLS feature, the
registry (seeded init and a timm-style checkpoint in a default dir), and
``embed_features("vit_hybrid", ...)``.

tpu_ac's TINY hybrid (tests/test_vit_hybrid.py: a pre-activation
ResNetV2 at block_counts (1, 1, 1, 1) and a 3-block, 64-wide ViT at 64
px) and the same ViT on vit_r50's own backbone layout (post-activation,
TF SAME, the "same" stem pool, ws eps 1e-6), at 96 px (a 3 x 3 grid, so
the position embedding is resized).  Tolerance: 3e-5 of the largest
|value|, where the other families take 1e-5: the tokens are a 2048-channel
1x1 projection of a stage-4 map that already differs by 4e-6 (of its max
|value|) after four weight-standardised stages, and the ViT blocks add to
it; measured 9.4e-6 on the pre-activation form.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import resnetv2 as jrv2
from tpu_ac.models import vit as jvit
from tpu_ac.models import vit_hybrid as jhyb
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import resnetv2 as trv2
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models import vit_hybrid as thyb

RTOL = 3e-5
VIT = dict(embed_dim=64, depth=3, num_heads=2, img_size=64)
FORMS = {
    "tiny": dict(block_counts=(1, 1, 1, 1), width_factor=1),
    "r50_layout": dict(block_counts=(1, 1, 1, 1), preact=False,
                       tf_same=True, stem_pool="same", ws_eps=1e-6),
}


def _images(b=2, size=96, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _configs(form: str):
    return (jhyb.HybridViTConfig(resnet=jrv2.ResNetV2Config(**FORMS[form]),
                                 vit=jvit.ViTConfig(**VIT)),
            thyb.HybridViTConfig(resnet=trv2.ResNetV2Config(**FORMS[form]),
                                 vit=tvit.ViTConfig(**VIT)))


def _register(form: str, ckpt: str | None = None) -> str:
    jcfg, tcfg = _configs(form)
    name = f"tiny_hybrid_{form}"
    jreg.register_backbone(name, jreg.BackboneSpec("vit_hybrid", jcfg, ckpt))
    treg.register_backbone(name, treg.BackboneSpec("vit_hybrid", tcfg, ckpt))
    return name


@pytest.mark.parametrize("form", sorted(FORMS))
def test_init_bit_identical(form):
    jcfg, tcfg = _configs(form)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jhyb.init_hybrid_vit_params(3, jcfg)
    tp = thyb.init_hybrid_vit_params(3, tcfg)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


def test_vit_r50_config_and_inventory():
    """The registered vit_r50 is tpu_ac's, and its module's keys and
    shapes (built on meta) are tpu_ac's init's."""
    jspec, tspec = jreg.BACKBONE_CONFIGS["vit_r50"], \
        treg.BACKBONE_CONFIGS["vit_r50"]
    assert dataclasses.asdict(tspec.config) == \
        dataclasses.asdict(jspec.config)
    from tpu_ac.models.manifest import load_manifests
    from tpu_ac_torch.models.manifest import generate_manifest

    assert generate_manifest("vit_r50") == load_manifests()["vit_r50"]


@pytest.mark.parametrize("form,size", [("tiny", 64), ("tiny", 96),
                                       ("r50_layout", 96)])
def test_taps_and_cls_match(form, size):
    """64 px is the pretraining grid (2 x 2); 96 px resizes the position
    embedding to 3 x 3."""
    name = _register(form)
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "vit_hybrid" and isinstance(model, thyb.HybridViT)
    x = _images(size=size)
    taps = (0, 2)
    want = jhyb.hybrid_vit_forward(jp, jnp.asarray(x), jcfg, taps=taps)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=taps)
        cls = thyb.hybrid_vit_cls_forward(model, torch.from_numpy(x))
    assert sorted(got) == sorted(taps)
    for t in taps:
        assert got[t].shape[1] == 1 + (size // 32) ** 2
        _close(got[t], want[t])
    _close(cls, jhyb.hybrid_vit_cls_forward(jp, jnp.asarray(x), jcfg))


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """A timm-style .pth (a head the trunk does not have, a module.
    prefix) only in a default dir: both packages load it, with the same
    weights."""
    name = _register("r50_layout", ckpt="tiny_hybrid.pth")
    params = thyb.init_hybrid_vit_params(9, _configs("r50_layout")[1])
    sd = {"module." + k: torch.from_numpy(v.copy())
          for k, v in params.items()}
    sd["module.head.weight"] = torch.zeros(10, 64)
    torch.save(sd, tmp_path / "tiny_hybrid.pth")
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
def test_embed_features_hybrid_matches(layernorm):
    """blocks.1 + blocks.2 at 96 px (a 3 x 3 grid, CLS dropped)."""
    name = _register("r50_layout")
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("blocks.1", "blocks.2"), pretrain_embed_dimension=48,
              target_embed_dimension=40, apply_layernorm=layernorm)
    x = _images(seed=1)
    want = jemb.embed_features("vit_hybrid", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 9, 40)
    _close(got, want)
