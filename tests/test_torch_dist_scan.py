"""One SCAN step of each kind (SimCLR, SCAN, SCAN head-only, self-label)
over two gloo ranks on the CPU, each rank on its half of the batch, at
tests/test_torch_scan.py's tiny sizes (batch 8: 4 a rank), against

- the port's one-process step on the whole batch, within 1e-5 (relative
  L2 per leaf of the state, the BN running statistics included; Adam's
  parameters element by element, 2 lr where the float64 gradient is
  below 1e-5, 1e-5 lr elsewhere): the same f32 ops summed in another
  order, the BN variance as E[x^2] - E[x]^2 over the ranks' sums;
- tpu_ac's ``dp_shard_step`` at dp 2 on its virtual devices, within
  tpu_ac's own f32 error plus that 1e-5: tpu_ac's f32 gradients through
  BatchNorm sit up to 5e-3 from float64 (tests/test_torch_scan.py), so
  each leaf's slack is tpu_ac's gap to the port's float64 whole-batch
  step (which equals tpu_ac's float64 step to 1e-9 there).

The two ranks end each step with the same state, bit for bit.  The ranks
run in processes of their own with a per-test timeout (RANKS_TIMEOUT,
150 s).
"""

from __future__ import annotations


import numpy as np
import pytest
import torch

from test_torch_multihost import _start_ranks, _wait_ranks
from tpu_ac_torch.models.resnet_cifar import CifarResNetConfig as TCfg
from tpu_ac_torch.train import optim as topt
from tpu_ac_torch.train import scan as ts
from tpu_ac_torch.utils.checkpoint import tree_flatten

BB = dict(block_counts=(1, 1, 1, 1), widths=(8, 16, 32, 64))
B = 8
LR = {"simclr": 0.05, "scan": 1e-3, "scan_head_only": 1e-3,
      "selflabel": 0.05}
KINDS = tuple(LR)
ADAM = ("scan", "scan_head_only")


def _batch():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((B, 3, 32, 32)).astype(np.float32)
    b = (a + 0.5 * rng.standard_normal((B, 3, 32, 32))).astype(np.float32)
    return a, b


def port_step(kind: str, a, b, dtype=torch.float32, mesh=None):
    """The port's step of ``kind`` from its seeded init on (a, b), through
    ``dp_shard_step`` on ``mesh`` where one is given: (loss, [state
    leaves], {name: gradient}, sorted param names)."""
    bb = TCfg(**BB)
    heads = 1 if kind == "selflabel" else 2
    mcfg = ts.SCANModelConfig(backbone=bb, feature_dim=16, n_clusters=4,
                              n_heads=heads)
    a, b = (torch.from_numpy(x).to(dtype) for x in (a, b))
    if kind == "simclr":
        p, bn = ts.init_contrastive_model(0, mcfg, "cpu")
        opt = ts._sgd(LR[kind])
    elif kind in ADAM:
        p, bn = ts.init_clustering_model(0, mcfg, "cpu")
        opt = topt.adam(LR[kind])
    else:
        p, bn = ts.init_clustering_model(0, mcfg, "cpu")
        opt = topt.sgd(LR[kind], momentum=0.9)
    state = ts.init_train_state({k: v.to(dtype) for k, v in p.items()},
                                {k: v.to(dtype) for k, v in bn.items()},
                                opt)
    if kind == "simclr":
        grads = ts.simclr_loss_and_grads(state, a, b, mcfg, 0.5)[2]
        step = ts.make_simclr_step(mcfg, opt, 0.5)
    elif kind in ADAM:
        head_only = kind != "scan"
        grads = ts.scan_loss_and_grads(state, a, b, mcfg, 2.0, head_only)[2]
        step = ts.make_scan_step(mcfg, opt, 2.0, head_only)
    else:
        grads = ts.selflabel_loss_and_grads(state, a, b, mcfg, 0.3)[2]
        step = ts.make_selflabel_step(mcfg, opt, 0.3, True)
    if mesh is not None:
        step = ts.dp_shard_step(step, mesh, 2)
    out = step(state, a, b)
    loss = out[1]["total"] if kind in ADAM else out[1]
    return (float(loss), [x.detach().numpy() for x in tree_flatten(out[0])],
            {k: g.double().numpy() for k, g in grads.items()},
            sorted(state.params))


_CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
coord, out = sys.argv[3], sys.argv[4]
sys.path.insert(0, "tests")
from tpu_ac_torch.distributed import Mesh, multihost_init
import test_torch_dist_scan as T

multihost_init(coordinator_address=coord, num_processes=world,
               process_id=rank)
a, b = T._batch()
m = len(a) // world
res = {}
for kind in T.KINDS:
    # this rank's half, through dp_shard_step on a mesh of the group's size
    loss, leaves, _, _ = T.port_step(kind, a[rank * m:(rank + 1) * m],
                                     b[rank * m:(rank + 1) * m],
                                     mesh=Mesh(["cpu"] * world))
    res[kind + "/loss"] = np.array(loss)
    for i, x in enumerate(leaves):
        res[f"{kind}/{i}"] = x
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _jax_dp2(kind: str):
    """tpu_ac's step of ``kind`` through its dp_shard_step at dp 2 on two of
    its virtual CPU devices: (loss, [state leaves]).  JAX is imported
    here, not at the top: the ranks import this module for port_step."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh as JMesh

    from tpu_ac.models.resnet_cifar import CifarResNetConfig as JCfg
    from tpu_ac.train import scan as js

    heads = 1 if kind == "selflabel" else 2
    mcfg = js.SCANModelConfig(backbone=JCfg(**BB), feature_dim=16,
                              n_clusters=4, n_heads=heads)
    if kind == "simclr":
        p, bn = js.init_contrastive_model(0, mcfg)
        opt = js._sgd(LR[kind])
        step = js.make_simclr_step(mcfg, opt, 0.5)
    elif kind in ADAM:
        p, bn = js.init_clustering_model(0, mcfg)
        opt = optax.adam(LR[kind])
        step = js.make_scan_step(mcfg, opt, 2.0, kind != "scan")
    else:
        p, bn = js.init_clustering_model(0, mcfg)
        opt = optax.sgd(LR[kind], momentum=0.9)
        step = js.make_selflabel_step(mcfg, opt, 0.3, True)
    mesh = JMesh(np.array(jax.devices()[:2]), ("dp",))
    sharded = js.dp_shard_step(step, mesh, 2)
    state = js.init_train_state(p, bn, opt)
    a, b = _batch()
    out = sharded(state, jnp.asarray(a), jnp.asarray(b))
    loss = out[1]["total"] if kind in ADAM else out[1]
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(out[0])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per kind: the two ranks' (loss, leaves), the port's whole-batch f32
    and float64 steps, tpu_ac's dp-2 step."""
    out = tmp_path_factory.mktemp("dist_scan")
    started = _start_ranks(_CHILD, 2, out)
    a, b = _batch()
    try:  # the references while the ranks run
        result = {kind: {"t32": port_step(kind, a, b),
                         "t64": port_step(kind, a, b, torch.float64),
                         "j32": _jax_dp2(kind)} for kind in KINDS}
    finally:
        _wait_ranks(started)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    for kind in KINDS:
        n = len([k for k in ranks[0] if k.startswith(kind + "/")]) - 1
        result[kind]["ranks"] = [(float(r[kind + "/loss"]),
                                  [r[f"{kind}/{i}"] for i in range(n)])
                                 for r in ranks]
    return result


def _check(kind, got, ref, t64, slack):
    """Each leaf of ``got`` against ``ref``: Adam's parameters element by
    element (2 lr where the float64 gradient is below 1e-5, 1e-5 lr
    elsewhere, + 1e-6 |p|), every other leaf in L2 (1e-5 of its norm),
    ``slack[i]`` added."""
    grads, names = t64[2], t64[3]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.astype(np.float64), b.astype(np.float64)
        if kind in ADAM and i < len(names):
            lr = LR[kind]
            allowed = (np.where(np.abs(grads[names[i]]) < 1e-5, 2 * lr,
                                1e-5 * lr) + 1e-6 * np.abs(b) + slack[i])
            assert np.all(np.abs(a - b) <= allowed), names[i]
        else:
            assert np.linalg.norm(a - b) <= (1e-5 * np.linalg.norm(b)
                                             + slack[i]), i


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_end_bit_equal(runs, kind):
    (l0, s0), (l1, s1) = runs[kind]["ranks"]
    assert l0 == l1
    for x, y in zip(s0, s1):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_equal_the_whole_batch_step(runs, kind):
    r = runs[kind]
    loss, leaves = r["ranks"][0]
    assert loss == pytest.approx(r["t32"][0], rel=1e-5)
    _check(kind, leaves, r["t32"][1], r["t64"], [0.0] * len(leaves))


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_equal_tpu_ac_dp_shard_step(runs, kind):
    r = runs[kind]
    names = r["t64"][3]
    slack = []
    for i, (a, b) in enumerate(zip(r["j32"][1], r["t64"][1])):
        d = np.abs(a.astype(np.float64) - b)
        slack.append(d if kind in ADAM and i < len(names)
                     else np.linalg.norm(d))
    loss, leaves = r["ranks"][0]
    assert loss == pytest.approx(r["j32"][0], rel=1e-5)
    _check(kind, leaves, r["j32"][1], r["t64"], slack)
