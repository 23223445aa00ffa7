"""The port's SCAN ResNets (tpu_ac_torch.models.resnet_cifar) against
tpu_ac's, on the CPU.

- init: bit-identical arrays under the same keys for RESNET18_CIFAR,
  RESNET18_STL and RESNET50_IMAGENET, and the module (built on the meta
  device) holds exactly those parameters and buffers.
- forwards, at tpu_ac's tiny test widths (blocks (1, 1, 1, 1), widths
  8-64) on 32 px images, in each stem and block variant: the features
  within 1e-5 (relative L2) in eval and in train mode, and the new BN
  running statistics within 1e-5; eval mode returns the statistics
  unchanged.  The same f32 ops summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_ac.models import resnet_cifar as jr
from tpu_ac_torch.models import resnet_cifar as tr

FULL = ("RESNET18_CIFAR", "RESNET18_STL", "RESNET50_IMAGENET")
TINY = {
    "basic": dict(block_counts=(1, 1, 1, 1), widths=(8, 16, 32, 64)),
    "stl_stem": dict(block_counts=(1, 1, 1, 1), widths=(8, 16, 32, 64),
                     stem_maxpool=True),
    "bottleneck": dict(block_counts=(1, 1, 1, 1), widths=(8, 16, 32, 64),
                       bottleneck=True, imagenet_stem=True,
                       stem_maxpool=True),
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", FULL)
def test_init_bit_identical(name):
    jp, js = jr.init_cifar_resnet(0, getattr(jr, name))
    tp, ts = tr.init_cifar_resnet(0, getattr(tr, name))
    assert jp.keys() == tp.keys() and js.keys() == ts.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], np.asarray(jp[k]))
    for k in js:
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]))
    model = tr.build_cifar_resnet(getattr(tr, name))
    assert dict(model.named_parameters()).keys() == tp.keys()
    assert dict(model.named_buffers()).keys() == ts.keys()
    for k, v in model.named_parameters():
        assert tuple(v.shape) == tp[k].shape, k


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal(
        (4, 3, 32, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs(images):
    """tpu_ac's forward of each tiny variant in each mode, computed once."""
    out = {}
    for variant, kw in TINY.items():
        cfg = jr.CifarResNetConfig(**kw)
        p, s = jr.init_cifar_resnet(1, cfg)
        for train in (False, True):
            f, ns = jr.cifar_resnet_forward(p, s, jnp.asarray(images), cfg,
                                            train=train)
            out[variant, train] = (np.asarray(f),
                                   {k: np.asarray(v) for k, v in ns.items()})
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", list(TINY))
def test_forward_matches_tpu_ac(jax_runs, images, variant, train):
    cfg = tr.CifarResNetConfig(**TINY[variant])
    p, s = tr.init_cifar_resnet(1, cfg)
    params = {k: torch.from_numpy(v) for k, v in p.items()}
    state = {k: torch.from_numpy(v) for k, v in s.items()}
    feats, new_state = tr.cifar_resnet_forward(
        params, state, torch.from_numpy(images), cfg, train=train)
    want_f, want_s = jax_runs[variant, train]
    assert feats.shape == want_f.shape
    assert _rel(feats, want_f) < 1e-5
    assert new_state.keys() == want_s.keys()
    for k in want_s:
        assert _rel(new_state[k], want_s[k]) < 1e-5, k
    moved = [k for k in s if not np.array_equal(new_state[k].numpy(), s[k])]
    if train:
        assert moved, "train mode must move the running statistics"
        # the caller's statistics are left as they were
        for k in s:
            np.testing.assert_array_equal(state[k].numpy(), s[k])
    else:
        assert not moved


def test_batchnorm_is_torch_batchnorm():
    """The biased batch variance normalizes, the unbiased one moves the
    running variance, momentum 0.1, eps 1e-5 (tpu_ac's _bn)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 8, 6, 6)).astype(np.float32) * 2 + 1)
    bn = tr.BatchNorm(8, 1e-5, 0.1)
    bn.train()
    y = bn(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    n = x.numel() / 8
    want = (x - mean[None, :, None, None]) / torch.sqrt(
        var[None, :, None, None] + 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var,
                               0.9 + 0.1 * var * n / (n - 1))
    bn.eval()
    torch.testing.assert_close(bn(x), F.batch_norm(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False,
        0.1, 1e-5))


def test_module_with_loaded_weights_equals_the_functional_forward(images):
    """``CifarResNet`` as a plain module (real storage, load_state_dict)
    computes what ``cifar_resnet_forward`` computes."""
    cfg = tr.CifarResNetConfig(**TINY["basic"])
    p, s = tr.init_cifar_resnet(2, cfg)
    tensors = {k: torch.from_numpy(v) for k, v in {**p, **s}.items()}
    model = tr.CifarResNet(cfg)
    model.load_state_dict(tensors)
    model.eval()
    x = torch.from_numpy(images)
    with torch.no_grad():
        got = model(x)
    want, _ = tr.cifar_resnet_forward(
        {k: tensors[k] for k in p}, {k: tensors[k] for k in s}, x, cfg)
    assert torch.equal(got, want)


def test_bound_rejects_a_wrong_state():
    cfg = tr.CifarResNetConfig(**TINY["basic"])
    p, s = tr.init_cifar_resnet(0, cfg)
    params = {k: torch.from_numpy(v) for k, v in p.items()}
    state = {k: torch.from_numpy(v) for k, v in s.items()}
    del state["bn1.running_var"]
    with pytest.raises(KeyError, match="buffers"):
        tr.cifar_resnet_forward(params, state, torch.zeros(1, 3, 32, 32),
                                cfg)
