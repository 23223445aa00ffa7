"""The port's process group (tpu_ac_torch.distributed.multihost_init and
collectives.py) in processes of their own on the CPU, beside tpu_ac's
multihost_init.

- tests/test_multihost.py's two-process reduction on the port: two gloo
  ranks all-reduce rank + 1 to 3;
- the collectives of the training steps on two ranks against their
  one-process meaning: exact (sums of two f32 values, and of zeros);
- the no-op rules of both packages on the same arguments, and the
  backend chosen once, never a fallback;
- tpu_ac's multi-process DINO fault (ROADMAP Queue 3): two processes that
  each run tpu_ac's own DINO step on a tiny ViT under its multihost_init,
  on different shards, end with different teachers (one replica a
  process), while the port's two ranks end bit for bit equal.

Each child is a fresh process with a per-test timeout (RANKS_TIMEOUT, 150
s); its output goes to a file, so a rank cannot block on a full pipe.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_ac_torch.distributed import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT = 150.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(script: str, n: int, out_dir) -> list:
    """``python -c script RANK N 127.0.0.1:PORT OUT_DIR`` for each rank, all
    at once, each one's output in OUT_DIR/rank<r>.log (a rank cannot block
    on a full pipe); returns [(process, log path)]."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    coord = f"127.0.0.1:{_free_port()}"
    ranks = []
    try:
        for r in range(n):
            log = os.path.join(out_dir, f"rank{r}.log")
            with open(log, "w") as f:
                ranks.append((subprocess.Popen(
                    [sys.executable, "-c", script, str(r), str(n), coord,
                     str(out_dir)], env=env, cwd=REPO, stdout=f,
                    stderr=subprocess.STDOUT), log))
    except BaseException:
        _stop(ranks)
        raise
    return ranks


def _stop(ranks) -> None:
    for p, _ in ranks:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait_ranks(ranks, timeout: float = RANKS_TIMEOUT) -> list[str]:
    """Wait for the ranks of ``_start_ranks``; fails (never skips) past
    ``timeout`` seconds or on a rank that failed; returns their logs."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in ranks:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"the ranks did not end within {timeout} s")
    finally:
        _stop(ranks)
    texts = []
    for r, (p, log) in enumerate(ranks):
        with open(log) as f:
            texts.append(f.read())
        assert p.returncode == 0, f"rank {r} failed:\n{texts[-1]}"
    return texts


def _run_ranks(script: str, n: int, out_dir) -> list[str]:
    """The ranks of ``script``, started and waited for."""
    return _wait_ranks(_start_ranks(script, n, out_dir))


_PORT_CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
coord, out = sys.argv[3], sys.argv[4]
from tpu_ac_torch.distributed import (multihost_init, process_count,
                                      process_index)
from tpu_ac_torch.distributed import collectives as C

multihost_init(coordinator_address=coord, num_processes=world,
               process_id=rank)
assert dist.get_backend() == "gloo", dist.get_backend()  # no card here
assert process_count() == 2 and process_index() == rank

# tests/test_multihost.py's reduction: rank + 1 summed to 3 on both ranks
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
total = float(t)
assert total == 3.0, total
print(f"rank {rank} ok total={total}", flush=True)

res = {}
rng = np.random.default_rng(10 + rank)
a = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
res["a"], res["b"] = a.numpy(), b.numpy()
m = C.all_reduce_dict({"a": a, "b": b}, "mean")
s = C.all_reduce_dict({"a": a, "b": b}, "sum")
res["mean_a"], res["mean_b"] = m["a"].numpy(), m["b"].numpy()
res["sum_a"], res["sum_b"] = s["a"].numpy(), s["b"].numpy()

# the gather and its gradient: loss_r = sum(w_r * gathered)
x = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
x.requires_grad_(True)
g = C.all_gather(x)
w = torch.from_numpy(np.random.default_rng(20 + rank).standard_normal(
    (4, 3)).astype(np.float32))
(g * w).sum().backward()
res["x"], res["gathered"], res["x_grad"] = (
    x.detach().numpy(), g.detach().numpy(), x.grad.numpy())

# the differentiable sum and the global mean
y = x.detach().clone().requires_grad_(True)
C.global_mean(y * y, dim=0).sum().backward()
res["mean_grad"] = y.grad.numpy()

z = torch.full((3,), float(rank))
C.broadcast_(z, src=1)
res["broadcast"] = z.numpy()

C.check_same_on_ranks({"p": torch.ones(4)}, "same")
try:
    C.check_same_on_ranks({"p": torch.full((4,), float(rank))}, "state")
except RuntimeError as e:
    res["raised"] = np.array(str(e))

# one DINO step of the port on this rank's shard (the fault test)
from tpu_ac_torch.models.vit import ViTConfig
from tpu_ac_torch.train import dino as td
vit = ViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2,
                img_size=32)
cfg = td.DINOConfig(out_dim=64, local_crops_number=2, global_size=32,
                    local_size=16, head_hidden_dim=32,
                    head_bottleneck_dim=16, epochs=2, steps_per_epoch=4)
crops = np.load(out + "/crops.npz")
state = td.init_dino_state(0, vit, cfg, device="cpu")
step = td.make_dino_train_step(vit, cfg)
state, _ = step(state, torch.from_numpy(crops[f"g{rank}"]),
                torch.from_numpy(crops[f"l{rank}"]), lr=1e-3, wd=0.04,
                teacher_momentum=0.996, teacher_temp=0.04, freeze_last=False)
for k, v in state.teacher.items():
    res["teacher/" + k] = v.numpy()
np.savez(f"{out}/port{rank}.npz", **res)
dist.destroy_process_group()
"""

_JAX_CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

rank, world = int(sys.argv[1]), int(sys.argv[2])
coord, out = sys.argv[3], sys.argv[4]
from tpu_ac.distributed.mesh import multihost_init
from tpu_ac.models.vit import ViTConfig
from tpu_ac.train import dino as jd

multihost_init(coordinator_address=coord, num_processes=world,
               process_id=rank)
assert jax.process_count() == 2
vit = ViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2,
                img_size=32)
cfg = jd.DINOConfig(out_dim=64, local_crops_number=2, global_size=32,
                    local_size=16, head_hidden_dim=32,
                    head_bottleneck_dim=16, epochs=2, steps_per_epoch=4)
crops = np.load(out + "/crops.npz")
# as tpu_ac/cli/dino.py runs it: the state and the step on this process's
# device, the batch its shard
state = jd.init_dino_state(0, vit, cfg)
step = jax.jit(jd.make_dino_train_step(vit, cfg))
state, _ = step(state, crops[f"g{rank}"], crops[f"l{rank}"],
                lr=np.float32(1e-3), wd=np.float32(0.04),
                teacher_momentum=np.float32(0.996),
                teacher_temp=np.float32(0.04), freeze_last=False)
np.savez(f"{out}/jax{rank}.npz",
         **{"teacher/" + k: np.asarray(v) for k, v in state.teacher.items()})
print(f"rank {rank} ok", flush=True)
jax.distributed.shutdown()
"""


def _crops(out_dir) -> None:
    """Each rank's shard of a batch of 4 images: 2 a rank, crop-major."""
    rng = np.random.default_rng(11)
    g = rng.standard_normal((2, 4, 3, 32, 32)).astype(np.float32)
    l = rng.standard_normal((2, 4, 3, 16, 16)).astype(np.float32)
    np.savez(os.path.join(out_dir, "crops.npz"), **{
        f"{v}{r}": x[:, 2 * r:2 * r + 2].reshape(-1, *x.shape[2:])
        for r in range(2) for v, x in (("g", g), ("l", l))})


@pytest.fixture(scope="module")
def port_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_ranks")
    _crops(out)
    logs = _run_ranks(_PORT_CHILD, 2, out)
    return logs, [dict(np.load(out / f"port{r}.npz")) for r in range(2)]


def test_two_process_psum(port_ranks):
    logs, _ = port_ranks
    for rank, log in enumerate(logs):
        assert f"rank {rank} ok total=3.0" in log, log


def test_collectives_on_two_ranks(port_ranks):
    """Each collective against its one-process meaning, on both ranks."""
    _, (r0, r1) = port_ranks
    for r in (r0, r1):
        np.testing.assert_array_equal(r["sum_a"], r0["a"] + r1["a"])
        np.testing.assert_array_equal(r["sum_b"], r0["b"] + r1["b"])
        np.testing.assert_array_equal(r["mean_a"], (r0["a"] + r1["a"]) / 2)
        np.testing.assert_array_equal(r["mean_b"], (r0["b"] + r1["b"]) / 2)
        np.testing.assert_array_equal(
            r["gathered"], np.concatenate([r0["x"], r1["x"]]))
        np.testing.assert_array_equal(r["broadcast"], np.full(3, 1.0))
        assert "1 of 2 differ" in str(r["raised"])
    # d/dx_r of sum_r' sum(w_r' * gathered): the rank's rows of w0 + w1
    w = [np.random.default_rng(20 + r).standard_normal((4, 3)).astype(
        np.float32) for r in range(2)]
    np.testing.assert_array_equal(r0["x_grad"], (w[0] + w[1])[:2])
    np.testing.assert_array_equal(r1["x_grad"], (w[0] + w[1])[2:])
    # each rank's loss is the global mean (the same on both): d/dy of
    # 2 x sum(mean over the 4 rows of y^2) = 2 * 2 y / 4
    for r in (r0, r1):
        np.testing.assert_allclose(r["mean_grad"], r["x"], rtol=1e-6)


def test_tpu_ac_multiprocess_dino_trains_replicas(port_ranks, tmp_path):
    """tpu_ac's two processes end one step with different teachers (each
    trained its own replica on its shard); the port's two ranks end it
    with the same teacher, bit for bit."""
    _crops(tmp_path)
    _run_ranks(_JAX_CHILD, 2, tmp_path)
    j0, j1 = (dict(np.load(tmp_path / f"jax{r}.npz")) for r in range(2))
    assert any(not np.array_equal(j0[k], j1[k]) for k in j0)
    _, (p0, p1) = port_ranks
    keys = [k for k in p0 if k.startswith("teacher/")]
    assert keys and sorted(keys) == sorted(j0)
    for k in keys:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


@pytest.mark.parametrize("kwargs,env", [
    (dict(num_processes=1), {}),
    (dict(num_processes=0, process_id=0), {}),
    (dict(), {}),
    (dict(), {"WORLD_SIZE": "1"}),
])
def test_no_op_rules_of_both_packages(monkeypatch, kwargs, env):
    """num_processes <= 1 and a bare call outside a cluster do nothing in
    either package, and neither joins a group.  (tpu_ac is imported here:
    the other test files' ranks import this module for its runner.)"""
    from tpu_ac.distributed import mesh as jmesh

    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "SLURM_JOB_NUM_NODES", "CLOUD_TPU_TASK_ID",
                "TPU_WORKER_HOSTNAMES", *tmesh.CLUSTER_ENV, "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    assert jmesh.multihost_init(**kwargs) is None
    assert tmesh.multihost_init(**kwargs) is None
    assert calls == []
    assert not torch.distributed.is_initialized()
    assert tmesh.process_count() == 1 and tmesh.process_index() == 0


def test_backend_chosen_once(monkeypatch):
    """Without a card the backend is gloo; a backend that fails to start
    raises, and no other is tried."""
    for var in (*tmesh.CLUSTER_ENV, "LOCAL_RANK", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []

    def init(backend, **kw):
        calls.append((backend, kw))
        if backend == "nccl":
            raise RuntimeError("nccl is not available")

    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    tmesh.multihost_init("127.0.0.1:1234", 2, 1)
    assert calls == [("gloo", dict(init_method="tcp://127.0.0.1:1234",
                                   world_size=2, rank=1))]
    calls.clear()
    with pytest.raises(RuntimeError, match="nccl"):
        tmesh.multihost_init("127.0.0.1:1234", 2, 0, backend="nccl")
    assert [c[0] for c in calls] == ["nccl"]
    calls.clear()
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    tmesh.multihost_init()
    assert calls == [("gloo", dict(init_method="env://", world_size=4,
                                   rank=3))]


def test_pool_close_leaves_an_inherited_tracker(monkeypatch):
    """A process spawned by torch.multiprocessing (cli.scan's train_dp
    ranks) holds only its parent's resource-tracker pipe, no pid: the
    last pool's close leaves that tracker to the parent (older CPython's
    _stop would waitpid(None)), and stops one that this process started."""
    from multiprocessing import resource_tracker

    from tpu_ac_torch.data import prefetch

    class Tracker:
        def __init__(self, pid):
            self._pid, self.stopped = pid, False

        def _stop(self):
            self.stopped = True

    for pid, stopped in ((None, False), (1234, True)):
        tracker = Tracker(pid)
        monkeypatch.setattr(resource_tracker, "_resource_tracker", tracker)
        prefetch._stop_servers()
        assert tracker.stopped is stopped
