"""tpu_ac_torch's eval library (models/vit.py ``intermediate_layers``,
train/evals.py) against tpu_ac's on the CPU, the same seeded inputs.

Tolerances (f32 on both sides; the sums run in other orders):
- ``intermediate_layers`` against ``vit_intermediate_layers`` at
  Precision.HIGHEST, at the pretraining size, a square resize and a
  non-square one (DAVIS's 480 x 832 scaled down): 1e-5;
- ``extract_features``, plain and on ``Mesh(["cpu"] * 2)``, against
  tpu_ac's plain and on 2 of its virtual devices: 1e-5;
- ``knn_classifier``: the same top-1/top-5, on features with no tie at
  the k-th neighbour;
- the probe: 20 steps from one carried state, loss and weights 1e-5;
- ``PCA``, ``compute_map``: mAP equal to 1e-6; ``multi_scale``: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_ac.models import vit as jvit
from tpu_ac.train import evals as jev
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.train import evals as tev

# a tiny ViT at the DINO layout: 16 px patches, a 4 x 4 pretraining grid
CFG = dict(patch_size=16, embed_dim=64, depth=3, num_heads=2, img_size=64)
TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return tvit.init_vit_params(0, tvit.ViTConfig(**CFG))


@pytest.fixture(scope="module")
def jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def model(params):
    return load_jax_params(tvit.ViT(tvit.ViTConfig(**CFG)), params).eval()


def _images(n, h, w, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, h, w)).astype(np.float32)


# 64 x 64: the pretraining grid; 80 x 80: Copydays' 320 scaled by 1/4;
# 128 x 208: DAVIS's 480 x 832 scaled down (8 x 13 patches, h != w)
@pytest.mark.parametrize("hw", [(64, 64), (80, 80), (128, 208)])
def test_intermediate_layers_matches(jparams, model, hw):
    x = _images(2, *hw)
    want = jvit.vit_intermediate_layers(jparams, jnp.asarray(x),
                                        jvit.ViTConfig(**CFG), n=2)
    with torch.inference_mode():
        got = model.intermediate_layers(torch.from_numpy(x), 2)
    n_tok = (hw[0] // 16) * (hw[1] // 16) + 1
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, n_tok, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_intermediate_layers_rejects_bad_n(model):
    with pytest.raises(ValueError, match="outside"):
        model.intermediate_layers(torch.zeros(1, 3, 64, 64), 4)


@pytest.mark.parametrize("hw", [(128, 208), (208, 128)])
def test_pos_encoding_non_square(params, model, hw):
    """The bicubic pos-embed resize at h != w, both orientations: the row
    scale comes from the height in both packages."""
    h, w = hw
    npatch = (h // 16) * (w // 16)
    want = jvit.interpolate_pos_encoding(
        {"pos_embed": jnp.asarray(params["pos_embed"])}, npatch, h, w,
        jvit.ViTConfig(**CFG))
    with torch.inference_mode():
        got = model.interpolate_pos_encoding(npatch, h, w)
    assert got.shape == (1, npatch + 1, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _jax_embed(p, x):
    return jvit.vit_cls_forward(p, x, jvit.ViTConfig(**CFG),
                                precision=jax.lax.Precision.DEFAULT)


@pytest.fixture(scope="module")
def cls_features(jparams):
    """(images, tpu_ac's CLS features: plain, on 2 virtual devices)."""
    from tpu_ac.distributed import get_mesh

    x = _images(10, 64, 64, seed=1)
    plain = jev.extract_features(_jax_embed, x, batch_size=4,
                                 params=jparams)
    sharded = jev.extract_features(_jax_embed, x, batch_size=4,
                                   mesh=get_mesh(2), params=jparams)
    return x, plain, sharded


@pytest.mark.parametrize("dp", [0, 2])
def test_extract_features_matches(model, cls_features, dp):
    x, plain, sharded = cls_features
    mesh = Mesh(["cpu"] * dp) if dp else None
    with torch.inference_mode():
        got = tev.extract_features(model.forward_cls, x, batch_size=4,
                                   mesh=mesh, device="cpu")
    assert got.shape == (10, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, sharded if dp else plain, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_extract_features_mesh_rejects_indivisible_batch(model):
    with pytest.raises(ValueError, match="divisible"):
        tev.extract_features(model.forward_cls, _images(4, 64, 64), 3,
                             mesh=Mesh(["cpu"] * 2), device="cpu")


def test_extract_features_needs_a_card_by_default(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tev.extract_features(model.forward_cls, _images(2, 64, 64), 2)


def _separated_features(rng, n, d, n_cls):
    centers = rng.standard_normal((n_cls, d))
    y = rng.integers(0, n_cls, n)
    f = centers[y] + 0.8 * rng.standard_normal((n, d))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    return f.astype(np.float32), y


def _no_tie_at_k(train, test, k):
    sims = np.sort(test.astype(np.float64) @ train.astype(np.float64).T,
                   axis=1)[:, ::-1]
    return np.all(sims[:, k - 1] - sims[:, k] > 1e-5)


@pytest.fixture(scope="module")
def knn_data():
    rng = np.random.default_rng(7)
    tf, ty = _separated_features(rng, 300, 32, 6)
    qf, qy = _separated_features(rng, 120, 32, 6)
    return tf, ty, qf, qy


@pytest.mark.parametrize("k", [1, 3, 20])
def test_knn_classifier_matches(knn_data, k):
    tf, ty, qf, qy = knn_data
    assert _no_tie_at_k(tf, qf, k)
    want = jev.knn_classifier(tf, ty, qf, qy, k=k, T=0.07, num_classes=6)
    got = tev.knn_classifier(tf, ty, qf, qy, k=k, T=0.07, num_classes=6,
                             device="cpu")
    assert got == want
    assert 0.0 <= got[0] <= got[1] <= 100.0


def test_knn_predictions_match_float64_vote(knn_data):
    """The vote's classes against a float64 numpy vote (the chunking at
    len // 100 = 1 query, 120 chunks)."""
    tf, ty, qf, _ = knn_data
    k, T = 20, 0.07
    got = tev.knn_predictions(tf, ty, qf, k, T, num_classes=6,
                              device="cpu")
    sims = qf.astype(np.float64) @ tf.astype(np.float64).T
    idx = np.argsort(-sims, axis=1)[:, :k]
    w = np.exp(np.take_along_axis(sims, idx, 1) / T)
    probs = np.zeros((len(qf), 6))
    for c in range(6):
        probs[:, c] = np.sum(w * (ty[idx] == c), axis=1)
    np.testing.assert_array_equal(got, np.argsort(-probs, axis=1)[:, :5])


def _probe_batches(seed=3, n=20):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 8, 24)).astype(np.float32)
    y = rng.integers(0, 5, (n, 8))
    return f, y


@pytest.mark.parametrize("dp", [0, 2])
def test_linear_probe_matches_from_carried_state(dp):
    """tpu_ac's probe takes 5 steps (so its momentum trace is live), its
    state carries to the port, and both take 20 more: each loss and the
    final weights within 1e-5."""
    feats, labels = _probe_batches()
    lrs = np.linspace(0.5, 0.05, 25)
    jstate, jstep, jpredict = jev.make_linear_probe(24, 5, lr=0.5)
    for i in range(5):
        jstate, _ = jstep(jstate, jnp.asarray(feats[i]),
                          jnp.asarray(labels[i]), jnp.float32(lrs[i]))
    carried = jax.tree.map(np.asarray, jstate)
    mesh = Mesh(["cpu"] * dp) if dp else None
    _, tstep, tpredict = tev.make_linear_probe(24, 5, lr=0.5, mesh=mesh,
                                               device="cpu")
    tstate = tev.probe_state_from_numpy(carried, device="cpu")
    np.testing.assert_array_equal(
        tev.probe_state_to_numpy(tstate).opt_state[1].trace["w"],
        np.asarray(jstate.opt_state[1][0].trace["w"]))
    for i in range(5, 25):
        jstate, jloss = jstep(jstate, jnp.asarray(feats[i % 20]),
                              jnp.asarray(labels[i % 20]),
                              jnp.float32(lrs[i]))
        tstate, tloss = tstep(tstate, torch.from_numpy(feats[i % 20]),
                              torch.from_numpy(labels[i % 20]),
                              float(lrs[i]))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL,
                                   atol=TOL)
    back = tev.probe_state_to_numpy(tstate)
    np.testing.assert_allclose(back.weight, np.asarray(jstate.weight),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(back.bias, np.asarray(jstate.bias), rtol=TOL,
                               atol=TOL)
    x = feats[0]
    np.testing.assert_allclose(
        tpredict(tstate, torch.from_numpy(x)).numpy(),
        np.asarray(jpredict(jstate, jnp.asarray(x))), rtol=1e-4, atol=TOL)


def test_linear_probe_init_equals_tpu_ac():
    jstate, _, _ = jev.make_linear_probe(24, 5, seed=4)
    tstate, _, _ = tev.make_linear_probe(24, 5, seed=4, device="cpu")
    np.testing.assert_array_equal(tstate.weight.numpy(),
                                  np.asarray(jstate.weight))
    assert not tstate.bias.any()


def test_linear_probe_mesh_rejects_indivisible_batch():
    state, step, _ = tev.make_linear_probe(4, 2, mesh=Mesh(["cpu"] * 2),
                                           device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        step(state, torch.zeros(3, 4), torch.zeros(3, dtype=torch.int64),
             0.1)


def test_pca_matches():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 12)).astype(np.float32)
    jp, tp = jev.PCA(dim=8, whit=0.5), tev.PCA(dim=8, whit=0.5)
    jp.fit(x)
    tp.fit(x)
    np.testing.assert_array_equal(tp.apply(x), jp.apply(x))


def test_compute_map_matches():
    rng = np.random.default_rng(6)
    n_db, n_q = 30, 5
    ranks = np.stack([rng.permutation(n_db) for _ in range(n_q)], axis=1)
    gnd = [{"ok": rng.choice(n_db, 4, replace=False),
            "junk": rng.choice(n_db, 2, replace=False)} for _ in range(n_q)]
    gnd.append({"ok": np.asarray([], np.int64)})  # an empty query
    ranks = np.concatenate([ranks, ranks[:, :1]], axis=1)
    want = jev.compute_map(ranks, gnd, (1, 5, 10))
    got = tev.compute_map(ranks, gnd, (1, 5, 10))
    assert abs(got[0] - want[0]) <= 1e-6
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-6)
    assert tev.compute_ap(np.asarray([0, 2]), 2) == \
        jev.compute_ap(np.asarray([0, 2]), 2)


def test_retrieval_evals_match():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((4, 16))
    db = rng.standard_normal((20, 16))
    gnd = [{"easy": [i, i + 4], "hard": [i + 8], "junk": [i + 12]}
           for i in range(4)]
    want = jev.revisited_retrieval_eval(q, db, gnd)
    got = tev.revisited_retrieval_eval(q, db, gnd)
    for key in ("mAP_M", "mAP_H"):
        assert abs(got[key] - want[key]) <= 1e-6
    for key in ("mP@k_M", "mP@k_H"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6)
    flat = [{"ok": np.asarray(g["easy"])} for g in gnd]
    assert abs(tev.image_retrieval_eval(q, db, flat)["mAP"]
               - jev.image_retrieval_eval(q, db, flat)["mAP"]) <= 1e-6
    np.testing.assert_array_equal(tev.retrieval_ranks(q, db),
                                  jev.retrieval_ranks(q, db))


def _crop16(x):
    """The retrieval CLI's crop to whole patches."""
    return x[:, :, :x.shape[2] // 16 * 16, :x.shape[3] // 16 * 16]


def test_multi_scale_matches(jparams, model):
    x = _images(2, 64, 96, seed=9)
    want = jev.multi_scale(jnp.asarray(x),
                           lambda xx: _jax_embed(jparams, _crop16(xx)))
    with torch.inference_mode():
        got = tev.multi_scale(torch.from_numpy(x),
                              lambda xx: model.forward_cls(_crop16(xx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_module_replicas_share_one_device(model):
    reps = tev.module_replicas(model, Mesh(["cpu"] * 3))
    assert list(reps) == [torch.device("cpu")]
    assert reps[torch.device("cpu")] is model


def test_eval_mesh_on_the_cpu():
    mesh = tev.eval_mesh(torch.device("cpu"))
    assert mesh.size == tev.CPU_DP
    assert tev.eval_mesh(torch.device("cpu"), 3).devices == \
        (torch.device("cpu"),) * 3
