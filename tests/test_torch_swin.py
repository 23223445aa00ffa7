"""tpu_ac_torch.models.swin vs tpu_ac on the CPU: the seeded init bit for
bit, the window machinery, every stage tap and the final normed grid, the
registry (seeded init, the index buffer outside the state dict, a
checkpoint in a default dir), and ``embed_features("swin", ...)``.

tpu_ac's MICRO Swin (tests/test_swin.py: patch 4, window 4, width 16,
depths (1, 2, 1)) at 64 px: stage grids 16, 8 and 4, so stage 1's second
block is shifted (masked) and stage 2, one window wide, is not.
Tolerance: 1e-5 of the largest |value| (both sides compute in f32;
matmuls sum in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import registry as jreg
from tpu_ac.models import swin as jswin
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import swin as tswin

RTOL = 1e-5
MICRO = dict(patch_size=4, window_size=4, embed_dim=16, depths=(1, 2, 1),
             num_heads=(2, 2, 2))
TAPS = ("layers.0", "layers.1", "layers.2")


def _images(b=2, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _register(ckpt: str | None = None) -> str:
    name = "micro_swin"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "swin", jswin.SwinConfig(**MICRO), ckpt))
    treg.register_backbone(name, treg.BackboneSpec(
        "swin", tswin.SwinConfig(**MICRO), ckpt))
    return name


@pytest.mark.parametrize("name", ["swin_tiny", "micro"])
def test_init_bit_identical(name):
    if name == "micro":
        jcfg, tcfg = jswin.SwinConfig(**MICRO), tswin.SwinConfig(**MICRO)
    else:
        jcfg = jreg.BACKBONE_CONFIGS[name].config
        tcfg = treg.BACKBONE_CONFIGS[name].config
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jswin.init_swin_params(3, jcfg)
    tp = tswin.init_swin_params(3, tcfg)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("w", [4, 7])
def test_window_machinery_matches(w):
    np.testing.assert_array_equal(tswin.relative_position_index(w),
                                  jswin.relative_position_index(w))
    np.testing.assert_array_equal(
        tswin.shifted_window_mask(4 * w, 2 * w, w, w // 2),
        jswin.shifted_window_mask(4 * w, 2 * w, w, w // 2))
    x = np.random.default_rng(1).standard_normal(
        (2, 2 * w, 3 * w, 5)).astype(np.float32)
    parts = tswin._window_partition(torch.from_numpy(x), w)
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x), w)))
    np.testing.assert_array_equal(
        tswin._window_reverse(parts, w, 2 * w, 3 * w).numpy(), x)


def test_index_buffer_is_outside_the_state_dict():
    """Built on meta and loaded, the index buffer holds the real index
    (reset_buffers) and is not a key: the manifests stay tpu_ac's."""
    model, _, _ = treg.load_backbone(_register())
    assert "relative_position_index" not in model.state_dict()
    np.testing.assert_array_equal(
        model.relative_position_index.numpy(),
        jswin.relative_position_index(4).reshape(-1))


def test_taps_and_final_match():
    name = _register()
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    assert family == "swin" and isinstance(model, tswin.Swin)
    x = _images()
    want = jswin.swin_forward(jp, jnp.asarray(x), jcfg, taps=TAPS)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=TAPS)
        final = model(torch.from_numpy(x))["final"]
    assert sorted(got) == sorted(TAPS)
    for t in TAPS:
        _close(got[t], want[t])
    _close(final, want["final"])


def test_forward_stops_after_deepest_tap():
    model, _, _ = treg.load_backbone(_register())
    with torch.no_grad():
        model.layers[0].downsample.reduction.weight.fill_(float("nan"))
        out = model(torch.from_numpy(_images()), taps=("layers.0",))
    assert list(out) == ["layers.0"]
    assert bool(torch.isfinite(out["layers.0"]).all())


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """A microsoft/timm-style .pth (the redundant relative_position_index
    and attn_mask buffers, a head) only in a default dir: both packages
    load it, with the same weights."""
    name = _register(ckpt="micro_swin.pth")
    params = tswin.init_swin_params(9, tswin.SwinConfig(**MICRO))
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
        16, 16, dtype=torch.int64)
    sd["layers.1.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    sd["head.weight"] = torch.zeros(10, 64)
    torch.save(sd, tmp_path / "micro_swin.pth")
    monkeypatch.setattr(jreg, "_DEFAULT_CKPT_DIRS", (str(tmp_path),))
    monkeypatch.setattr(treg, "_DEFAULT_CKPT_DIRS", (str(tmp_path),))
    jp, _, _ = jreg.load_backbone(name)
    model, _, _ = treg.load_backbone(name)
    state = model.state_dict()
    assert sorted(state) == sorted(params)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), params[k], err_msg=k)
    for k, v in params.items():
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("layernorm", [False, True])
def test_embed_features_swin_matches(layernorm):
    """layers.0 (16 x 16) + layers.1 (8 x 8) at 64 px."""
    name = _register()
    jp, jcfg, _ = jreg.load_backbone(name)
    model, _, family = treg.load_backbone(name)
    kw = dict(layers=("layers.0", "layers.1"), pretrain_embed_dimension=48,
              target_embed_dimension=40, apply_layernorm=layernorm)
    x = _images(seed=1)
    want = jemb.embed_features("swin", jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 256, 40)
    _close(got, want)
