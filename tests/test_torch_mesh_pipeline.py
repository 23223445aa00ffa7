"""The dp branches of tpu_ac_torch.pipeline on a virtual CPU mesh
(``Mesh(["cpu"] * dp)``) against tpu_ac's on its 8-device CPU mesh
(tests/conftest.py) and against the port's own single-device path.

Tolerances:
- mesh vs tpu_ac's mesh: W agrees to 1e-5 (test_torch_distributed.py);
  alpha = softmax(W / tau) moves by at most 2 max|dW| / tau relative,
  about 2.5e-4 at W ~ 11 and tau 1, so alpha rtol 2.5e-4; X = alpha @ Z
  then moves by at most that times max|Z|.  The whole sweep adds the embed
  (rtol 1e-4 in f32, test_torch_embedding.py), which moves W by about as
  much relative, so alpha and X there get 1e-3 x the same scales.
- mesh vs the single-device path: tpu_ac's own (tests/test_distributed.py
  TestPipelineMeshPath, rtol 2e-3, atol 5e-4 on alpha): the single-device
  sweep sums the self-term mins[i, i], whose compensated-f32 floor the
  triangle scheme never computes.
- the embedder on a mesh vs on one device: rtol 2e-5, atol 2e-6 (the same
  per-image arithmetic at another batch size).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac import pipeline as jpipe
from tpu_ac.data import make_synthetic_mvtec
from tpu_ac.distributed import get_mesh as jax_get_mesh
from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac.models.vit import init_vit_params as jax_init
from tpu_ac_torch import pipeline as tpipe
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.models.vit import ViT, ViTConfig

VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
EMBED = dict(layers=("blocks.0", "blocks.1"), pretrain_embed_dimension=96,
             target_embed_dimension=192, resize=36, imagesize=32,
             precision="highest")


def _z(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 16, 64)).astype(
        np.float32)


def _model():
    cfg = ViTConfig(**VIT)
    return load_jax_params(ViT(cfg), jax_init(0, JViTConfig(**VIT))).eval()


def _close_alpha_x(a, x, a_want, x_want, z, rtol):
    a, x, a_want, x_want = (np.asarray(t) for t in (a, x, a_want, x_want))
    assert a.shape == a_want.shape and x.shape == x_want.shape
    np.testing.assert_allclose(a, a_want, rtol=rtol, atol=1e-7)
    np.testing.assert_allclose(x, x_want, rtol=rtol,
                               atol=rtol * np.abs(z).max())


def test_unsupervised_mesh_matches_tpu_ac_and_single_device():
    Z = _z(10, 0)
    ja, jx = jpipe.compute_alpha_X(jnp.asarray(Z), "unsupervised", 1.0,
                                   use_mesh=True)
    zt = torch.from_numpy(Z)
    ta, tx = tpipe.compute_alpha_X(zt, "unsupervised", 1.0, use_mesh=True,
                                   mesh=Mesh(["cpu"] * 8))
    _close_alpha_x(ta, tx, ja, jx, Z, 2.5e-4)
    sa, sx = tpipe.compute_alpha_X(zt, "unsupervised", 1.0)
    np.testing.assert_allclose(ta.numpy(), sa.numpy(), rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(tx.numpy(), sx.numpy(), rtol=2e-3, atol=1e-3)
    # packed: the same numbers in one [N, P + D] tensor
    packed = tpipe.compute_alpha_X(zt, "unsupervised", 1.0, use_mesh=True,
                                   mesh=Mesh(["cpu"] * 8), packed=True)
    assert torch.equal(packed, torch.cat([ta, tx], dim=1))


def test_supervised_mesh_matches_tpu_ac_and_single_device():
    Z, Zt = _z(9, 1), _z(5, 2)
    ja, jx = jpipe.compute_alpha_X(jnp.asarray(Z), "supervised", 1.0,
                                   Z_train=jnp.asarray(Zt), use_mesh=True)
    ta, tx = tpipe.compute_alpha_X(
        torch.from_numpy(Z), "supervised", 1.0, Z_train=torch.from_numpy(Zt),
        use_mesh=True, mesh=Mesh(["cpu"] * 4))
    _close_alpha_x(ta, tx, ja, jx, Z, 2.5e-4)
    sa, _ = tpipe.compute_alpha_X(torch.from_numpy(Z), "supervised", 1.0,
                                  Z_train=torch.from_numpy(Zt))
    np.testing.assert_allclose(ta.numpy(), sa.numpy(), rtol=5e-4, atol=1e-6)


def test_average_ignores_the_mesh():
    zt = torch.from_numpy(_z(4, 3))
    a, x = tpipe.compute_alpha_X(zt, "average", 1.0, use_mesh=True,
                                 mesh=Mesh(["cpu"] * 2))
    a1, x1 = tpipe.compute_alpha_X(zt, "average", 1.0)
    assert torch.equal(a, a1) and torch.equal(x, x1)


def test_default_on_cpu_is_single_device(monkeypatch):
    """use_mesh=None never picks a mesh for CPU tensors."""
    def boom(*a, **k):
        raise AssertionError("the mesh branch ran")

    monkeypatch.setattr(tpipe, "_alpha_x_mesh", boom)
    tpipe.compute_alpha_X(torch.from_numpy(_z(3, 4)), "unsupervised", 1.0)


def test_embedder_on_mesh_matches_one_device():
    cfg = tpipe.PipelineConfig(batch_size=8, **EMBED)
    imgs = np.random.default_rng(5).integers(0, 255, (11, 3, 32, 32)) \
        .astype(np.uint8)
    single = tpipe.CategoryEmbedder(_model(), cfg, device="cpu")
    sharded = tpipe.CategoryEmbedder(_model(), cfg, device="cpu",
                                     mesh=Mesh(["cpu"] * 4))
    assert single.mesh is None and sharded.mesh.size == 4
    z1, z4 = single(imgs), sharded(imgs)
    assert z4.shape == z1.shape == (11, 16, 192)
    np.testing.assert_allclose(z4.numpy(), z1.numpy(), rtol=2e-5, atol=2e-6)


def test_auto_mesh_is_none_on_a_cpu_host():
    cfg = tpipe.PipelineConfig(batch_size=8, **EMBED)
    emb = tpipe.CategoryEmbedder(_model(), cfg, device="cpu", mesh="auto")
    assert emb.mesh is None
    if torch.cuda.device_count() <= 1:
        with pytest.raises(ValueError, match="devices are available"):
            tpipe.compute_alpha_X(torch.from_numpy(_z(3, 6)),
                                  "unsupervised", 1.0, use_mesh=True)


def test_mesh_needs_a_divisible_batch():
    cfg = tpipe.PipelineConfig(batch_size=6, **EMBED)
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.CategoryEmbedder(_model(), cfg, device="cpu",
                               mesh=Mesh(["cpu"] * 4))


def test_sweep_on_mesh_matches_tpu_ac(tmp_path):
    """The slice as a whole: run_category_sweep with the dp embed and the
    triangle alpha on a virtual 8-rank mesh against tpu_ac's sweep on its
    8-device mesh (dp embed, and its default mesh alpha), f32."""
    root = str(tmp_path / "mvtec")
    make_synthetic_mvtec(root, image_size=48)
    jcfg = jpipe.PipelineConfig(batch_size=8, **EMBED)
    tcfg = tpipe.PipelineConfig(batch_size=8, **EMBED)
    jemb = jpipe.CategoryEmbedder(jax_init(0, JViTConfig(**VIT)),
                                  JViTConfig(**VIT), jcfg,
                                  mesh=jax_get_mesh(8))
    temb = tpipe.CategoryEmbedder(_model(), tcfg, device="cpu",
                                  mesh=Mesh(["cpu"] * 8))
    (_, want), = jpipe.run_category_sweep(root, ["bottle"], jcfg, jemb)
    (_, got), = tpipe.run_category_sweep(root, ["bottle"], tcfg, temb)
    jemb.close()
    assert got["alpha"].shape == want["alpha"].shape == (12, 16)
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(got["X"], want["X"], rtol=1e-3,
                               atol=1e-3 * np.abs(want["X"]).max())
    assert got["anomaly_labels"] == want["anomaly_labels"]


@pytest.mark.cuda
def test_mesh_on_distinct_cards():
    """On two or more cards the mesh spans distinct devices (peer copies for
    the gather and the partial sums, one model replica per card) and must
    give what a virtual mesh of as many ranks on one card gives: the same
    kernels on the same inputs, rtol 1e-6.  ``"auto"`` and the default
    ``use_mesh`` take every card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards")
    from tpu_ac_torch.distributed import get_mesh

    n = torch.cuda.device_count()
    real, virtual = get_mesh(n), Mesh(["cuda:0"] * n)
    assert len(real.distinct_devices) == n
    z = torch.from_numpy(_z(10, 7)).cuda()
    zt = torch.from_numpy(_z(5, 8)).cuda()
    for mode, train in (("unsupervised", None), ("supervised", zt)):
        want = tpipe.compute_alpha_X(z, mode, 1.0, train, use_mesh=True,
                                     mesh=virtual, packed=True)
        for kw in ({"use_mesh": True, "mesh": real}, {}):
            got = tpipe.compute_alpha_X(z, mode, 1.0, train, packed=True,
                                        **kw)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    batch = 8 if 8 % n == 0 else n
    cfg = tpipe.PipelineConfig(batch_size=batch, **EMBED)
    imgs = np.random.default_rng(9).integers(0, 255, (11, 3, 32, 32)) \
        .astype(np.uint8)
    single = tpipe.CategoryEmbedder(_model(), cfg, device="cuda", mesh=None)
    sharded = tpipe.CategoryEmbedder(_model(), cfg, device="cuda",
                                     mesh="auto")
    assert sharded.mesh is not None and len(sharded._models) == n
    torch.testing.assert_close(sharded(imgs), single(imgs), rtol=2e-5,
                               atol=2e-6)
