"""tpu_ac_torch.models.inception (Inception-v4 and BN-Inception) vs tpu_ac
on the CPU: the seeded init bit for bit, the taps across the trunk, the
registry (seeded init and a checkpoint in a default dir), and
``embed_features("inception_v4" | "bninception", ...)``.

Both families have one config (their full width), run here on small
images as tpu_ac's own tests run them: Inception-v4 at 96 px,
BN-Inception at 64 px.  The pools are where the two differ (average
pools without / with the padded zeros counted, ceil-mode max pools), so a
swap shows at the borders of every tap.  Tolerance: 1e-5 of the largest
|value| (both sides compute in f32; convs sum in different orders), except
for the embeddings, held to 5e-5: tpu_ac's f32 ad-hoc LayerNorm over a
large ReLU'd map drifts from a float64 evaluation (BN-Inception's
inception_3b at 128 px, 82k values an image with a mean near 1.5: 2.8e-5
of max |value|) where the port's ``F.layer_norm`` stays within 6e-8.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import inception as jinc
from tpu_ac.models import registry as jreg
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import inception as tinc
from tpu_ac_torch.models import registry as treg

RTOL = 1e-5
EMBED_RTOL = 5e-5
FAMILIES = {"inception_v4": ("inception_v4_forward",
                             "init_inception_v4_params"),
            "bninception": ("bninception_forward",
                            "init_bninception_params")}
TAPS = {"inception_v4": ("features.2", "features.5", "features.9",
                         "features.10", "features.17", "features.21"),
        "bninception": ("inception_3b", "inception_3c", "inception_4e",
                        "inception_5b")}
SIZE = {"inception_v4": 96, "bninception": 64}


def _images(b=2, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def loaded():
    """Each family's registry name loaded by both packages (seeded init)."""
    return {name: (jreg.load_backbone(name), treg.load_backbone(name))
            for name in FAMILIES}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_init_bit_identical(name, loaded):
    (jp, _, _), (model, _, _) = loaded[name]
    init = FAMILIES[name][1]
    tp = getattr(tinc, init)(0, treg.BACKBONE_CONFIGS[name].config)
    assert sorted(tp) == sorted(jp) == sorted(model.state_dict())
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_taps_match(name, loaded):
    (jp, jcfg, _), (model, _, family) = loaded[name]
    assert family == name
    x = _images(size=SIZE[name])
    taps = TAPS[name]
    want = getattr(jinc, FAMILIES[name][0])(jp, jnp.asarray(x), jcfg,
                                            taps=taps)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=taps)
    assert sorted(got) == sorted(taps)
    for t in taps:
        _close(got[t], want[t])


def test_pools_are_the_upstream_ones():
    """ceil-mode max pool and the two average-pool counts, against torch's
    own modules on an odd size (where ceil mode adds a window)."""
    x = torch.from_numpy(_images(1, 10))
    torch.testing.assert_close(
        tinc._maxpool_ceil(x), torch.nn.MaxPool2d(3, 2, ceil_mode=True)(x))
    assert tinc._maxpool_ceil(x).shape[-1] == 5
    torch.testing.assert_close(
        tinc._avgpool_noinc(x),
        F.avg_pool2d(x, 3, 1, 1, count_include_pad=False))
    inc = F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
    assert not torch.allclose(tinc._avgpool_noinc(x), inc)
    np.testing.assert_allclose(
        np.asarray(jinc._avgpool_3x3_s1_incpad(jnp.asarray(x.numpy()))),
        inc.numpy(), rtol=1e-6, atol=1e-6)


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """BN-Inception's flat-named .pth (BN counters, the last_linear head)
    only in a default dir: both packages load it, with the same weights."""
    name = "tiny_bninception_ckpt"
    jreg.register_backbone(name, jreg.BackboneSpec(
        "bninception", jinc.BNINCEPTION, "bni.pth"))
    treg.register_backbone(name, treg.BackboneSpec(
        "bninception", tinc.BNINCEPTION, "bni.pth"))
    params = tinc.init_bninception_params(9, tinc.BNINCEPTION)
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["conv1_7x7_s2_bn.num_batches_tracked"] = torch.tensor(7)
    sd["last_linear.weight"] = torch.zeros(10, 1024)
    torch.save(sd, tmp_path / "bni.pth")
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


@pytest.mark.parametrize("name,layers", [
    ("inception_v4", ("features.9", "features.17")),
    ("bninception", ("inception_3b", "inception_4d"))])
def test_embed_features_matches(name, layers, loaded):
    """Two taps a factor ~2 apart at the taps test's sizes (Inception-v4
    at 96 px: 9 x 9 and 4 x 4; BN-Inception at 64 px: 8 x 8 and 4 x 4),
    clustering tail."""
    (jp, jcfg, _), (model, _, family) = loaded[name]
    kw = dict(layers=layers, pretrain_embed_dimension=96,
              target_embed_dimension=80)
    x = _images(size=SIZE[name], seed=1)
    want = jemb.embed_features(family, jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert got.shape[-1] == 80
    _close(got, want, EMBED_RTOL)
