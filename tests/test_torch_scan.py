"""The port's SCAN training (tpu_ac_torch.train.scan, train.optim,
cluster.metrics.hungarian_evaluate) against tpu_ac's, on the CPU, on the
same seeded numpy inputs at tpu_ac's tiny test sizes (ResNet blocks
(1, 1, 1, 1), widths 8-64, feature_dim 16, 32 px, batch 8).

Tolerances:
- losses, the optimizers' updates, the contrastive and clustering
  forwards: 1e-6 relative (losses and optimizers) and 1e-5 (forwards), the
  same f32 ops in other orders.
- one train step of each kind: tpu_ac's f32 gradients through BatchNorm
  are not exact: JAX differentiates the batch mean and variance op by op,
  and on these inputs its f32 gradients sit up to 5e-3 (relative L2 per
  parameter) from the float64 ones, where torch's analytic batch_norm
  backward sits at 1e-6.  So each step is held three ways: in float64
  (tpu_ac under ``jax.enable_x64``) the two packages agree to 1e-9; the
  port's f32 step sits within 1e-5 of the float64 one (relative L2 per
  leaf of the state: params, BN statistics, momentum or Adam moments,
  EMA); and the port's f32 step is no further from tpu_ac's f32 step than
  tpu_ac's own f32 error plus that 1e-5.  Adam's first step is lr * g /
  (|g| + eps), about lr * sign(g), and it moves by lr * eps / (|g| +
  eps)^2 for each unit of error in g: its parameters are held element by
  element, to 2 lr where the float64 gradient is below 1e-5 (1000 eps:
  there f32 noise of 1e-9 in g may move the step by 1e-5 lr or flip
  it), and to 1e-5 lr elsewhere.
- neighbour mining: the indices equal where the scores do not tie; where
  they do (duplicate rows), the two picks tie in float64 within 1e-5.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_ac.cluster import metrics as jmetrics
from tpu_ac.models.resnet_cifar import CifarResNetConfig as JCfg
from tpu_ac.train import scan as js
from tpu_ac_torch.cluster import metrics as tmetrics
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.models.resnet_cifar import CifarResNetConfig as TCfg
from tpu_ac_torch.train import optim as topt
from tpu_ac_torch.train import scan as ts
from tpu_ac_torch.utils.checkpoint import tree_flatten

BB = dict(block_counts=(1, 1, 1, 1), widths=(8, 16, 32, 64))
J_TINY = js.SCANModelConfig(backbone=JCfg(**BB), feature_dim=16,
                            n_clusters=4, n_heads=2)
T_TINY = ts.SCANModelConfig(backbone=TCfg(**BB), feature_dim=16,
                            n_clusters=4, n_heads=2)
J_ONE = js.SCANModelConfig(backbone=JCfg(**BB), feature_dim=16,
                           n_clusters=4, n_heads=1)
T_ONE = ts.SCANModelConfig(backbone=TCfg(**BB), feature_dim=16,
                           n_clusters=4, n_heads=1)
B = 8
LR = {"simclr": 0.05, "scan": 1e-3, "scan_head_only": 1e-3,
      "selflabel": 0.05, "selflabel_ema": 0.05}
KINDS = tuple(LR)
ADAM = ("scan", "scan_head_only")


def _batch():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((B, 3, 32, 32)).astype(np.float32)
    b = (a + 0.5 * rng.standard_normal((B, 3, 32, 32))).astype(np.float32)
    return a, b


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# Losses and optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.1, 0.5])
def test_simclr_loss(temperature):
    f = np.random.default_rng(0).standard_normal((6, 2, 8)).astype(
        np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    want = float(js.simclr_loss(jnp.asarray(f), temperature))
    got = float(ts.simclr_loss(torch.from_numpy(f), temperature))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("shape", [(4,), (8, 4)])
def test_entropy(shape):
    p = np.random.default_rng(1).random(shape).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    p[..., 0] = 0.0  # the EPS clamp
    assert float(ts.entropy(torch.from_numpy(p))) == pytest.approx(
        float(js.entropy(jnp.asarray(p))), rel=1e-6)


def test_scan_loss():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((8, 4)).astype(np.float32)
    n = rng.standard_normal((8, 4)).astype(np.float32)
    want = js.scan_loss(jnp.asarray(a), jnp.asarray(n), 2.0)
    got = ts.scan_loss(torch.from_numpy(a), torch.from_numpy(n), 2.0)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-6)


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("threshold", [0.7, 0.9999])
def test_confidence_based_ce(balance, threshold):
    rng = np.random.default_rng(3)
    weak = rng.standard_normal((16, 4)).astype(np.float32) * 4
    strong = rng.standard_normal((16, 4)).astype(np.float32)
    want = float(js.confidence_based_ce(jnp.asarray(weak),
                                        jnp.asarray(strong), threshold,
                                        balance))
    got = float(ts.confidence_based_ce(torch.from_numpy(weak),
                                       torch.from_numpy(strong), threshold,
                                       balance))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def _rand_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a.weight": rng.standard_normal((3, 4)).astype(np.float32),
            "a.bias": rng.standard_normal((4,)).astype(np.float32),
            "b": rng.standard_normal((2, 2, 3)).astype(np.float32)}


@pytest.mark.parametrize("name,jopt,topt_", [
    ("sgd", optax.sgd(0.1), topt.sgd(0.1)),
    ("momentum", optax.sgd(0.1, momentum=0.9),
     topt.sgd(0.1, momentum=0.9)),
    ("nesterov", optax.sgd(0.1, momentum=0.9, nesterov=True),
     topt.sgd(0.1, momentum=0.9, nesterov=True)),
    ("_sgd", js._sgd(0.1), ts._sgd(0.1)),
    ("adam", optax.adam(1e-3), topt.adam(1e-3)),
])
def test_optimizers_match_optax(name, jopt, topt_):
    """Three updates of random gradients: the updates and every leaf of
    the state, in jax.tree.flatten order, within 1e-6 relative (and 1e-6
    of the leaf's largest element: a fused multiply-add rounds once)."""
    p = _rand_tree(0)
    jstate, tstate = jopt.init(p), topt_.init(
        {k: torch.from_numpy(v) for k, v in p.items()})
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    jparams = dict(p)
    for i in range(3):
        g = _rand_tree(10 + i)
        ju, jstate = jopt.update(g, jstate, jparams)
        tu, tstate = topt_.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, tstate, tparams)
        jparams = optax.apply_updates(jparams, ju)
        tparams = topt.apply_updates(tparams, tu)
        for k in p:
            want = np.asarray(ju[k])
            np.testing.assert_allclose(tu[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tl = [x.numpy() for x in tree_flatten(tstate)]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())


# --------------------------------------------------------------------------
# Models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_contrastive_model(head):
    jcfg = js.SCANModelConfig(backbone=J_TINY.backbone, feature_dim=16,
                              head=head)
    tcfg = ts.SCANModelConfig(backbone=T_TINY.backbone, feature_dim=16,
                              head=head)
    jp, jb = js.init_contrastive_model(3, jcfg)
    tp, tb = ts.init_contrastive_model(3, tcfg, device="cpu")
    assert jp.keys() == tp.keys() and jb.keys() == tb.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    x = _batch()[0]
    for train in (False, True):
        je, jf, jn = js.contrastive_forward(jp, jb, x, jcfg, train=train)
        te, tf, tn = ts.contrastive_forward(tp, tb, torch.from_numpy(x),
                                            tcfg, train=train)
        assert _rel(te.detach(), je) < 1e-5 and _rel(tf.detach(), jf) < 1e-5
        for k in jn:
            assert _rel(tn[k], jn[k]) < 1e-5, k


def test_clustering_model_logits():
    jp, jb = js.init_clustering_model(4, J_TINY)
    tp, tb = ts.init_clustering_model(4, T_TINY, device="cpu")
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    x = _batch()[1]
    for train in (False, True):
        jl, _, jn = js.clustering_forward(jp, jb, x, J_TINY, train=train)
        tl, _, tn = ts.clustering_forward(tp, tb, torch.from_numpy(x),
                                          T_TINY, train=train)
        assert tl.shape == (2, B, 4)
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-5)
        for k in jn:
            assert _rel(tn[k], jn[k]) < 1e-5, k


def test_evaluate_and_prototypes():
    """contrastive_evaluate's kNN accuracy and get_prototypes' picks equal
    tpu_ac's (tpu_ac's own test's separable set)."""
    local = np.random.default_rng(7)
    imgs = local.standard_normal((16, 3, 32, 32)).astype(np.float32) * 0.1
    imgs[:8, 0] += 3.0
    targets = np.array([0] * 8 + [1] * 8)
    jp, jb = js.init_contrastive_model(0, J_TINY)
    tp, tb = ts.init_contrastive_model(0, T_TINY, device="cpu")
    jemb = js.contrastive_forward(jp, jb, jnp.asarray(imgs), J_TINY)[0]
    temb = ts.contrastive_forward(tp, tb, torch.from_numpy(imgs), T_TINY)[0]
    jbank = js.MemoryBank(16, 16, num_classes=2)
    jbank.update(np.asarray(jemb), targets)
    tbank = ts.MemoryBank(16, 16, num_classes=2, device="cpu")
    tbank.update(temb.detach(), targets)
    assert ts.contrastive_evaluate(tp, tb, imgs, targets, tbank, T_TINY) == \
        js.contrastive_evaluate(jp, jb, imgs, targets, jbank, J_TINY)
    cp, cb = ts.init_clustering_model(0, T_TINY, device="cpu")
    jcp, jcb = js.init_clustering_model(0, J_TINY)
    np.testing.assert_array_equal(
        ts.get_prototypes(cp, cb, imgs, T_TINY, head=1),
        js.get_prototypes(jcp, jcb, imgs, J_TINY, head=1))


# --------------------------------------------------------------------------
# Memory bank
# --------------------------------------------------------------------------

def test_bank_update_wraps_like_tpu_ac():
    rng = np.random.default_rng(0)
    jbank = js.MemoryBank(n=10, dim=4, num_classes=3)
    tbank = ts.MemoryBank(n=10, dim=4, num_classes=3, device="cpu")
    for _ in range(3):  # 24 rows into 10: wraps twice
        f = rng.standard_normal((8, 4)).astype(np.float32)
        t = rng.integers(0, 3, 8)
        jbank.update(f, t)
        tbank.update(torch.from_numpy(f), t)
        assert tbank.ptr == jbank.ptr
        np.testing.assert_array_equal(tbank.features.numpy(), jbank.features)
        np.testing.assert_array_equal(tbank.targets, jbank.targets)


def _bank_rows():
    """120 normalized rows in 3 classes, a quarter of them duplicated (the
    near-duplicate synthetic images whose scores tie)."""
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((3, 16)) * 2
    labels = rng.integers(0, 3, 120)
    f = centers[labels] + rng.standard_normal((120, 16))
    f[90:] = f[:30]
    labels[90:] = labels[:30]
    f = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
    return f, labels


def _check_neighbours(got, want, feats):
    """Equal indices where the scores do not tie; where they differ, both
    picks score the same in float64 (within 1e-5), and the two sets differ
    only by such ties."""
    assert got.shape == want.shape and got.dtype == want.dtype
    s = feats.astype(np.float64) @ feats.astype(np.float64).T
    for i in range(len(got)):
        for g, w in zip(got[i], want[i]):
            if g != w:
                assert abs(s[i, g] - s[i, w]) <= 1e-5, (i, g, w)
        extra = set(got[i]) - set(want[i])
        floor = min(s[i, j] for j in want[i])
        assert all(s[i, j] >= floor - 1e-5 for j in extra), i


@pytest.fixture(scope="module")
def mined():
    f, labels = _bank_rows()
    jbank = js.MemoryBank(len(f), 16, num_classes=3)
    jbank.update(f, labels)
    jidx, jacc = jbank.mine_nearest_neighbors(5)
    jbank.mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dp",))
    jsidx, jsacc = jbank.mine_nearest_neighbors(5)
    return f, labels, (jidx, jacc), (jsidx, jsacc)


def test_mining_matches_tpu_ac(mined):
    f, labels, (jidx, jacc), _ = mined
    bank = ts.MemoryBank(len(f), 16, num_classes=3, device="cpu")
    bank.update(f, labels)
    idx, acc = bank.mine_nearest_neighbors(5)
    _check_neighbours(idx, jidx, f)
    np.testing.assert_array_equal(idx[:, 0][:90], np.arange(90))
    assert acc == pytest.approx(jacc, abs=2 / (5 * len(f)))


def test_mining_sharded_on_a_cpu_mesh_matches_tpu_ac(mined):
    """knn_ip_sharded on Mesh(["cpu"] * 4) against tpu_ac's on 4 of its
    virtual devices."""
    f, labels, _, (jsidx, jsacc) = mined
    bank = ts.MemoryBank(len(f), 16, num_classes=3,
                         mesh=Mesh(["cpu"] * 4), device="cpu")
    bank.update(f, labels)
    idx, acc = bank.mine_nearest_neighbors(5)
    _check_neighbours(idx, jsidx, f)
    assert acc == pytest.approx(jsacc, abs=2 / (5 * len(f)))


def test_weighted_knn_matches_tpu_ac():
    f, labels = _bank_rows()
    q = f[::7] + 0.05
    jbank = js.MemoryBank(len(f), 16, num_classes=3)
    jbank.update(f, labels)
    tbank = ts.MemoryBank(len(f), 16, num_classes=3, device="cpu")
    tbank.update(f, labels)
    for k in (5, 200):
        np.testing.assert_array_equal(tbank.weighted_knn(q, k=k),
                                      jbank.weighted_knn(q, k=k))


# --------------------------------------------------------------------------
# Train steps
# --------------------------------------------------------------------------

def _jax_step(kind, x64: bool):
    """tpu_ac's step of ``kind`` from its seeded init on ``_batch()``:
    (loss, [state leaves], [ema leaves] or None), as numpy."""
    a, b = _batch()
    ctx = jax.enable_x64(True) if x64 else contextlib.nullcontext()
    with ctx:
        dt = jnp.float64 if x64 else jnp.float32

        def cast(tree):
            return {k: jnp.asarray(np.asarray(v), dt) for k, v in tree.items()}

        if kind == "simclr":
            p, bn = js.init_contrastive_model(0, J_TINY)
            opt = js._sgd(LR[kind])
            step = js.make_simclr_step(J_TINY, opt, 0.5)
        elif kind in ADAM:
            p, bn = js.init_clustering_model(0, J_TINY)
            opt = optax.adam(LR[kind])
            step = js.make_scan_step(J_TINY, opt, 2.0, kind != "scan")
        else:
            p, bn = js.init_clustering_model(0, J_ONE)
            opt = optax.sgd(LR[kind], momentum=0.9)
            step = js.make_selflabel_step(
                J_ONE, opt, 0.3, True,
                0.9 if kind == "selflabel_ema" else None)
        p, bn = cast(p), cast(bn)
        state = js.init_train_state(p, bn, opt)
        args = (state, jnp.asarray(a, dt), jnp.asarray(b, dt))
        if kind == "selflabel_ema":
            args += (dict(p),)
        out = jax.jit(step)(*args)
        loss = out[1]["total"] if kind in ADAM else out[1]
        ema = out[2] if kind == "selflabel_ema" else None
        return (float(loss), [np.asarray(x) for x in jax.tree.leaves(out[0])],
                None if ema is None else [np.asarray(ema[k])
                                          for k in sorted(ema)])


def _port_step(kind, dtype):
    """The port's step: (loss, [state leaves], [ema leaves] or None,
    {name: gradient}, names of the param leaves)."""
    a, b = (torch.from_numpy(x).to(dtype) for x in _batch())

    def cast(tree):
        return {k: v.to(dtype) for k, v in tree.items()}

    if kind == "simclr":
        p, bn = ts.init_contrastive_model(0, T_TINY, "cpu")
        opt = ts._sgd(LR[kind])
        state = ts.init_train_state(cast(p), cast(bn), opt)
        grads = ts.simclr_loss_and_grads(state, a, b, T_TINY, 0.5)[2]
        out = ts.make_simclr_step(T_TINY, opt, 0.5)(state, a, b)
    elif kind in ADAM:
        p, bn = ts.init_clustering_model(0, T_TINY, "cpu")
        opt = topt.adam(LR[kind])
        state = ts.init_train_state(cast(p), cast(bn), opt)
        head_only = kind != "scan"
        grads = ts.scan_loss_and_grads(state, a, b, T_TINY, 2.0,
                                       head_only)[2]
        out = ts.make_scan_step(T_TINY, opt, 2.0, head_only)(state, a, b)
    else:
        p, bn = ts.init_clustering_model(0, T_ONE, "cpu")
        opt = topt.sgd(LR[kind], momentum=0.9)
        state = ts.init_train_state(cast(p), cast(bn), opt)
        grads = ts.selflabel_loss_and_grads(state, a, b, T_ONE, 0.3)[2]
        step = ts.make_selflabel_step(T_ONE, opt, 0.3, True,
                                      0.9 if kind == "selflabel_ema"
                                      else None)
        out = step(state, a, b, dict(state.params)) \
            if kind == "selflabel_ema" else step(state, a, b)
    loss = out[1]["total"] if kind in ADAM else out[1]
    ema = out[2] if kind == "selflabel_ema" else None
    return (float(loss), [x.detach().numpy() for x in tree_flatten(out[0])],
            None if ema is None else [ema[k].numpy() for k in sorted(ema)],
            {k: g.double().numpy() for k, g in grads.items()},
            sorted(state.params))


@pytest.fixture(scope="module")
def steps():
    """Every kind's step in both packages, f32 and float64, computed
    once."""
    return {kind: {"j32": _jax_step(kind, False),
                   "j64": _jax_step(kind, True),
                   "t32": _port_step(kind, torch.float32),
                   "t64": _port_step(kind, torch.float64)}
            for kind in KINDS}


def _all_leaves(run):
    return run[1] + (run[2] or [])


def _check_f32(kind, got, ref, run64, slack):
    """Each leaf of ``got`` against ``ref``: Adam's parameters element by
    element (2 lr where the float64 gradient is below 1e-5, 1e-5 lr
    elsewhere, + 1e-6 |p|), every other leaf in L2 (1e-5 of its norm);
    ``slack[i]`` (elementwise for Adam's parameters, a norm otherwise) is
    added to the bound."""
    grads, names = run64[3], run64[4]
    for i, (a, b) in enumerate(zip(_all_leaves(got), _all_leaves(ref))):
        a, b = a.astype(np.float64), b.astype(np.float64)
        if kind in ADAM and i < len(names):
            lr = LR[kind]
            allowed = (np.where(np.abs(grads[names[i]]) < 1e-5, 2 * lr,
                                1e-5 * lr) + 1e-6 * np.abs(b) + slack[i])
            assert np.all(np.abs(a - b) <= allowed), names[i]
        else:
            bound = 1e-5 * np.linalg.norm(b) + slack[i]
            assert np.linalg.norm(a - b) <= bound, i


@pytest.mark.parametrize("kind", KINDS)
def test_step_float64_equals_tpu_ac(steps, kind):
    """The same arithmetic: in float64 the port's step and tpu_ac's agree
    in the loss and every leaf of the state to 1e-9."""
    j, t = steps[kind]["j64"], steps[kind]["t64"]
    assert t[0] == pytest.approx(j[0], rel=1e-9)
    assert len(_all_leaves(t)) == len(_all_leaves(j))
    for i, (a, b) in enumerate(zip(_all_leaves(t), _all_leaves(j))):
        assert np.abs(a - b).max() <= 1e-9 * max(np.abs(b).max(), 1e-3), i


@pytest.mark.parametrize("kind", KINDS)
def test_step_f32_within_1e5_of_float64(steps, kind):
    t32, t64 = steps[kind]["t32"], steps[kind]["t64"]
    assert t32[0] == pytest.approx(t64[0], rel=1e-5)
    _check_f32(kind, t32, t64, t64, [0.0] * len(_all_leaves(t64)))


@pytest.mark.parametrize("kind", KINDS)
def test_step_f32_against_tpu_ac(steps, kind):
    """No further from tpu_ac's f32 step than tpu_ac is from the float64
    step, plus the port's own bound (see the module docstring)."""
    s = steps[kind]
    names = s["t64"][4]
    j_err = []
    for i, (a, b) in enumerate(zip(_all_leaves(s["j32"]),
                                   _all_leaves(s["j64"]))):
        d = np.abs(a.astype(np.float64) - b)
        j_err.append(d if kind in ADAM and i < len(names)
                     else np.linalg.norm(d))
    assert s["t32"][0] == pytest.approx(s["j32"][0], rel=1e-5)
    _check_f32(kind, s["t32"], s["j32"], s["t64"], j_err)


def test_head_only_freezes_the_backbone(steps):
    """Head-only SCAN: every backbone parameter bit-equal to its init (no
    weight-decay drift), the heads moved, Adam's moments advanced."""
    p, _ = ts.init_clustering_model(0, T_TINY, "cpu")
    names = sorted(p)
    leaves = steps["scan_head_only"]["t32"][1]
    for i, k in enumerate(names):
        if k.startswith("cluster_head"):
            assert not np.array_equal(leaves[i], p[k].numpy()), k
        else:
            np.testing.assert_array_equal(leaves[i], p[k].numpy())


def test_state_round_trip_from_tpu_ac():
    """scan_state_from_numpy takes tpu_ac's optax state (the _sgd chain's
    trace) leaf for leaf; scan_state_to_numpy gives it back."""
    p, bn = js.init_contrastive_model(0, J_TINY)
    opt = js._sgd(0.1)
    a, b = _batch()
    jstate, _ = jax.jit(js.make_simclr_step(J_TINY, opt, 0.5))(
        js.init_train_state(p, bn, opt), a, b)
    host = jax.tree.map(np.asarray, jstate)
    state = ts.scan_state_from_numpy(host, ts._sgd(0.1), "cpu")
    back = tree_flatten(ts.scan_state_to_numpy(state))
    want = jax.tree.leaves(host)
    assert len(back) == len(want)
    for x, y in zip(back, want):
        np.testing.assert_array_equal(x, y)


def test_dp_step_on_a_virtual_mesh_is_the_whole_batch_step():
    p, bn = ts.init_contrastive_model(0, T_TINY, "cpu")
    opt = ts._sgd(0.05)
    step = ts.make_simclr_step(T_TINY, opt, 0.5)
    a, b = (torch.from_numpy(x) for x in _batch())
    want = step(ts.init_train_state(p, bn, opt), a, b)
    got = ts.dp_shard_step(step, Mesh(["cpu"] * 4), 2)(
        ts.init_train_state(p, bn, opt), a, b)
    assert float(got[1]) == float(want[1])
    for x, y in zip(tree_flatten(got[0]), tree_flatten(want[0])):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="train_dp"):
        ts.dp_shard_step(step, Mesh(["cpu"] * 3), 2)(
            ts.init_train_state(p, bn, opt), a, b)


def test_dp_step_on_distinct_cards_raises():
    """Without a process group: distinct cards need one process a card
    (tests/test_torch_dist_scan.py runs the group)."""
    with pytest.raises(RuntimeError, match="one process a device"):
        ts.dp_shard_step(lambda s, a, b: (s, a), Mesh(["cuda:0", "cuda:1"]),
                         2)


# --------------------------------------------------------------------------
# Hungarian evaluation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_classes", [3, 7])
def test_hungarian_evaluate_matches_tpu_ac(n_classes):
    """SCAN's evaluation on fewer than 5 and on 5+ clusters: equal ACC,
    Top-5 and match; NMI and ARI (closed forms against sklearn's) to
    1e-12."""
    rng = np.random.default_rng(n_classes)
    targets = rng.integers(0, n_classes, 300)
    logits = rng.standard_normal((300, n_classes))
    logits[np.arange(300), (targets + 1) % n_classes] += 2.0
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want = jmetrics.hungarian_evaluate(probs, targets, True)
    got = tmetrics.hungarian_evaluate(probs, targets, True)
    assert got["ACC"] == want["ACC"]
    assert got["ACC Top-5"] == want["ACC Top-5"]
    assert got["hungarian_match"] == want["hungarian_match"]
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])
    for k in ("NMI", "ARI"):
        assert got[k] == pytest.approx(want[k], abs=1e-12)
