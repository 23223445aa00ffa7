"""tpu_ac_torch.models vs tpu_ac.models on the CPU: the seeded init, the
tapped ViT forward (square input and a 48x32 input that resizes the
positional embedding) and the checked params carry-over.

Tolerance of the forward: rtol 1e-4, atol 1e-5 against
``tpu_ac.models.vit.vit_forward`` at Precision.HIGHEST — f32 on both
sides, four blocks of differently ordered sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_ac.models import vit as jvit
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_jax_params, state_dict_from_jax
from tpu_ac_torch.models.registry import load_backbone

CFG = dict(patch_size=8, embed_dim=64, depth=4, num_heads=4, img_size=32)


@pytest.fixture(scope="module")
def params():
    return tvit.init_vit_params(0, tvit.ViTConfig(**CFG))


@pytest.fixture(scope="module")
def model(params):
    m = tvit.ViT(tvit.ViTConfig(**CFG))
    return load_jax_params(m, params).eval()


@pytest.mark.parametrize("prefix", [1, 2])
def test_init_bit_identical(prefix):
    jp = jvit.init_vit_params(3, jvit.ViTConfig(**CFG,
                                                num_prefix_tokens=prefix))
    tp = tvit.init_vit_params(3, tvit.ViTConfig(**CFG,
                                                num_prefix_tokens=prefix))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k], err_msg=k)


@pytest.mark.parametrize("hw", [(32, 32), (48, 32)])
def test_tapped_forward_matches(params, model, hw):
    x = np.random.default_rng(1).standard_normal((2, 3, *hw)).astype(
        np.float32)
    taps = (1, 3)
    want = jvit.vit_forward({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), jvit.ViTConfig(**CFG), taps=taps,
                            precision=jax.lax.Precision.HIGHEST)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), taps=taps)
    assert sorted(got) == list(taps)
    n_tok = (hw[0] // 8) * (hw[1] // 8) + 1
    for t in taps:
        assert got[t].shape == (2, n_tok, 64)
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   rtol=1e-4, atol=1e-5)


def test_forward_stops_after_deepest_tap(model):
    x = torch.zeros(1, 3, 32, 32)
    calls = []
    hooks = [b.register_forward_hook(lambda *a, i=i: calls.append(i))
             for i, b in enumerate(model.blocks)]
    try:
        model(x, taps=(1,))
    finally:
        for h in hooks:
            h.remove()
    assert calls == [0, 1]


def test_flash_attention_not_ported(model):
    """attention_impl="flash" is ported: on the CPU it runs the kernel's
    plain version, gives the dense forward's tokens (rtol 1e-5, f32 on both
    sides) and launches nothing; an unknown impl raises."""
    from tpu_ac_torch.kernels import attention

    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    before = attention.LAUNCHES
    with torch.inference_mode():
        dense = model(x, taps=(3,))
        flash = model(x, taps=(3,), attention_impl="flash")
    np.testing.assert_allclose(flash[3].numpy(), dense[3].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert attention.LAUNCHES == before
    with pytest.raises(ValueError, match="attention_impl"):
        model(x, taps=(0,), attention_impl="pallas")


def test_converter_rejects_missing_key(params):
    bad = dict(params)
    del bad["blocks.0.attn.qkv.bias"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(tvit.ViT(tvit.ViTConfig(**CFG)), bad)


def test_converter_rejects_extra_key(params):
    bad = dict(params, **{"head.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(tvit.ViT(tvit.ViTConfig(**CFG)), bad)


def test_converter_rejects_shape_mismatch(params):
    bad = dict(params, cls_token=np.zeros((1, 1, 32), np.float32))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tvit.ViT(tvit.ViTConfig(**CFG)), bad)


def test_state_dict_copies(params):
    sd = state_dict_from_jax(params)
    assert sd["pos_embed"].dtype == torch.float32
    sd["pos_embed"].zero_()
    assert np.abs(params["pos_embed"]).sum() > 0


def test_load_backbone_random_init_is_tpu_ac_init():
    model, cfg, family = load_backbone("dino_deitsmall16", seed=5)
    assert family == "vit" and cfg.embed_dim == 384
    want = jvit.init_vit_params(5, cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_load_backbone_reads_pth(tmp_path, params):
    from tpu_ac_torch.models.registry import BackboneSpec, register_backbone

    register_backbone("tiny_pth_test", BackboneSpec(
        "vit", tvit.ViTConfig(**CFG), "tiny.pth"))
    sd = {"module." + k: v for k, v in state_dict_from_jax(params).items()}
    torch.save(sd, tmp_path / "tiny.pth")
    model, _, _ = load_backbone("tiny_pth_test",
                                checkpoint_dir=str(tmp_path), seed=99)
    np.testing.assert_array_equal(model.pos_embed.detach().numpy(),
                                  params["pos_embed"])
