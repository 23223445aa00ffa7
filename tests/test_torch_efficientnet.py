"""tpu_ac_torch.models.efficientnet (EfficientNet B-series, EfficientNetV2,
MnasNet) vs tpu_ac on the CPU: the seeded init bit for bit, the stage
taps, the registry (seeded init and a timm-style checkpoint in a default
dir), and ``embed_features`` of each of the three families.

The configs are those of tpu_ac's oracle tests
(tests/test_convnet_oracle.py): B0 with TF SAME padding and with the
symmetric k//2 one (b3a's form: tf_same off, BN eps 1e-5), the reduced
V2 stages (ConvBnAct, EdgeResidual, MBConv with SE) and the reduced
MnasNet stages (DepthwiseSeparable, MBConv with and without SE), at 33
px, an odd size where SAME pads asymmetrically at stride 2; the BN
statistics are perturbed so the normalisation does work.  Tolerance:
1e-5 of the largest |value| (both sides compute in f32; convs sum in
different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.features import embedding as jemb
from tpu_ac.models import efficientnet as jeff
from tpu_ac.models import registry as jreg
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import efficientnet as teff
from tpu_ac_torch.models import registry as treg

RTOL = 1e-5
V2_STAGES = (
    ("cn", 1, 8, 2, 1, 3, False),
    ("er", 2, 12, 2, 2, 3, False),
    ("ir", 2, 16, 2, 2, 3, True),
)
MNAS_STAGES = (
    ("ds", 1, 8, 1, 1, 3, False),
    ("ir", 3, 12, 2, 2, 5, False),
    ("ir", 2, 16, 2, 2, 3, True),
)
# form -> (family, base config name, fields replaced in it)
FORMS = {
    "b0_same": ("efficientnet", "EFFICIENTNET_B0", dict(tf_same=True)),
    "b0_sym": ("efficientnet", "EFFICIENTNET_B0",
               dict(tf_same=False, bn_eps=1e-5)),
    "v2_same": ("efficientnetv2", "EFFICIENTNETV2_M",
                dict(stages=V2_STAGES, stem_channels=8)),
    "v2_sym": ("efficientnetv2", "EFFICIENTNETV2_M",
               dict(stages=V2_STAGES, stem_channels=8, tf_same=False)),
    "mnasnet": ("mnasnet", "MNASNET_B1",
                dict(stages=MNAS_STAGES, stem_channels=8)),
}
TAPS = ("stage1", "stage2", "stage3")
FORWARD = {"efficientnet": "efficientnet_forward",
           "efficientnetv2": "efficientnetv2_forward",
           "mnasnet": "mnasnet_forward"}
INIT = {"efficientnet": "init_efficientnet_params",
        "efficientnetv2": "init_efficientnetv2_params",
        "mnasnet": "init_mnasnet_params"}


def _images(b=2, size=33, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _configs(form: str):
    family, base, kw = FORMS[form]
    return (family, dataclasses.replace(getattr(jeff, base), **kw),
            dataclasses.replace(getattr(teff, base), **kw))


def _register(form: str, ckpt: str | None = None) -> str:
    family, jcfg, tcfg = _configs(form)
    name = f"tiny_effnet_{form}"
    jreg.register_backbone(name, jreg.BackboneSpec(family, jcfg, ckpt))
    treg.register_backbone(name, treg.BackboneSpec(family, tcfg, ckpt))
    return name


def _perturbed(params, seed: int) -> dict[str, np.ndarray]:
    """Non-trivial BN statistics and scales, as tpu_ac's oracle tests."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if "running" in k or k.endswith(("bn1.weight", "bn2.weight",
                                         "bn3.weight")):
            v = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            if "running_var" in k:
                v = np.abs(v)
        out[k] = v
    return out


@pytest.mark.parametrize("name", ["efficientnet_b1", "efficientnet_b3a",
                                  "efficientnetv2_m", "mnasnet_a1"])
def test_init_bit_identical(name):
    jspec, tspec = jreg.BACKBONE_CONFIGS[name], treg.BACKBONE_CONFIGS[name]
    assert dataclasses.asdict(tspec.config) == \
        dataclasses.asdict(jspec.config)
    init = INIT[tspec.family]
    jp = getattr(jeff, init)(3, jspec.config)
    tp = getattr(teff, init)(3, tspec.config)
    assert list(tp) == list(jp)  # the same draws in the same order
    for k, v in tp.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_taps_match(form):
    name = _register(form)
    jp, jcfg, family = jreg.load_backbone(name)
    model, _, _ = treg.load_backbone(name)
    assert model.family == family
    params = _perturbed(jp, seed=17)
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in params.items()})
    x = _images()
    want = getattr(jeff, FORWARD[family])(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jcfg, taps=TAPS)
    with torch.no_grad():
        got = model(torch.from_numpy(x), taps=TAPS)
    assert sorted(got) == sorted(TAPS)
    for t in TAPS:
        _close(got[t], want[t])


def test_tf_same_pads_like_tpu_ac():
    from tpu_ac.ops.pooling import tf_same_pads as jpads
    from tpu_ac_torch.models.layers import tf_same_pads

    for size in (1, 2, 7, 32, 33, 224, 225):
        for k in (1, 3, 5, 7):
            for s in (1, 2):
                assert tf_same_pads(size, k, s) == jpads(size, k, s)


def test_checkpoint_in_default_dir_loads_like_tpu_ac(tmp_path, monkeypatch):
    """A timm-style .pth (BN counters, conv_head/classifier) only in a
    default dir: both packages load it, with the same weights."""
    name = _register("b0_same", ckpt="tiny_effnet.pth")
    _, _, tcfg = _configs("b0_same")
    params = teff.init_efficientnet_params(9, tcfg)
    sd = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sd["bn1.num_batches_tracked"] = torch.tensor(7)
    sd["classifier.weight"] = torch.zeros(10, 1280)
    torch.save(sd, tmp_path / "tiny_effnet.pth")
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


@pytest.mark.parametrize("form", ["b0_same", "v2_same", "mnasnet"])
def test_embed_features_matches(form):
    """stage2 (9 x 9) + stage3 (5 x 5) at 33 px, clustering tail."""
    name = _register(form)
    jp, jcfg, family = jreg.load_backbone(name)
    model, _, _ = treg.load_backbone(name)
    kw = dict(layers=("stage2", "stage3"), pretrain_embed_dimension=48,
              target_embed_dimension=40)
    x = _images(seed=1)
    want = jemb.embed_features(family, jp, jnp.asarray(x), jcfg,
                               jemb.EmbedConfig(**kw))
    with torch.no_grad():
        got = temb.embed_features(family, model, torch.from_numpy(x),
                                  temb.EmbedConfig(**kw))
    assert tuple(got.shape) == (2, 81, 40)
    _close(got, want)
