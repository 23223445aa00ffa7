"""The port's DINO head (tpu_ac_torch.models.dino_head) against tpu_ac's:
the seeded init bit-identical, the forward within 1e-6 (f32, the same
ops in another summation order) at every head depth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ac.models import dino_head as jhead
from tpu_ac_torch.models import dino_head as thead

KW = dict(in_dim=32, out_dim=64, hidden_dim=48, bottleneck_dim=16)


def _head(nlayers, seed=3):
    params = thead.init_dino_head_params(seed, nlayers=nlayers, **KW)
    head = thead.DINOHead(KW["in_dim"], KW["out_dim"], nlayers=nlayers,
                          hidden_dim=KW["hidden_dim"],
                          bottleneck_dim=KW["bottleneck_dim"])
    head.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return params, head


@pytest.mark.parametrize("nlayers", [1, 2, 3])
def test_init_bit_identical(nlayers):
    want = jhead.init_dino_head_params(3, nlayers=nlayers, **KW)
    got = thead.init_dino_head_params(3, nlayers=nlayers, **KW)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("nlayers", [1, 3])
def test_state_dict_keys_are_the_params_keys(nlayers):
    params, head = _head(nlayers)
    assert sorted(head.state_dict()) == sorted(params)


@pytest.mark.parametrize("nlayers", [1, 2, 3])
def test_forward_matches_tpu_ac(nlayers):
    params, head = _head(nlayers)
    x = np.random.default_rng(0).standard_normal((10, 32)).astype(np.float32)
    want = np.asarray(jhead.dino_head_forward(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_weight_norm_rows():
    """The last layer's weight is weight_g * weight_v / ||weight_v||: with
    weight_g 1 its rows are unit vectors, so a unit input gives |out| <= 1."""
    params, head = _head(3)
    v = torch.from_numpy(params["last_layer.weight_v"])
    x = torch.nn.functional.normalize(torch.randn(4, 16), dim=-1)
    with torch.no_grad():
        out = head.last_layer(x)
    w = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    torch.testing.assert_close(out, x @ w.T, rtol=1e-6, atol=1e-6)
    assert out.abs().max() <= 1.0 + 1e-6
