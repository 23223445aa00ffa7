"""Both SCAN CLIs (tpu_ac.cli.scan, tpu_ac_torch.cli.scan) on one micro
synthetic config (tests/test_scan_cli.py's: 2 classes x 8 images at 32 px,
ResNet-18, 2 heads, top-3 neighbours, batch 8), on the CPU.

- The artifacts have tpu_ac's layout: the same files, the same checkpoint
  leaves (count, dtypes, shapes, extras) and the same neighbour arrays'
  dtype and shape; the eval scores are equal.
- The pretext models after SimCLR's 2 steps at lr 0.05 within 1e-2
  (relative L2 over every array): tpu_ac's f32 gradients through
  BatchNorm sit up to 5e-3 from the float64 ones (test_torch_scan.py),
  the port's at 1e-6, and 2 steps at this lr carry that into the
  parameters (3.8e-3 measured).  Later stages are compared one at a time,
  each fed by tpu_ac's artifacts of the stage before (the cross-package
  handoff): SCAN's 2 Adam steps at 1e-4 within 1e-3 (Adam's first steps
  are about lr * sign(g), which rounding may flip where g is near 0;
  8.2e-5 measured), self-labeling's 2 SGD steps within 1e-5 (2.3e-7
  measured).  Each package's eval of the other's self-label model gives
  the other's scores.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from tpu_ac.cli import scan as jcli
from tpu_ac.config import create_config as j_create_config
from tpu_ac_torch.cli import scan as tcli

EXP = ("train_db_name: synthetic\nnum_classes: 2\nsynthetic_per_class: 8\n"
       "image_size: 32\nnum_heads: 2\nnum_neighbors: 3\nbatch_size: 8\n"
       "epochs: 1\nfeature_dim: 16\nlr: 0.05\nnum_workers: 0\n")
STAGES = ("simclr", "scan", "selflabel")


def _write_cfg(root, exp=EXP):
    os.makedirs(root, exist_ok=True)
    env = os.path.join(root, "env.yml")
    with open(env, "w") as f:
        f.write(f"root_dir: {root}/out\n")
    path = os.path.join(root, "exp.yml")
    with open(path, "w") as f:
        f.write(exp)
    return env, path


def _port(stage, env, exp):
    return tcli.main([stage, "--config_env", env, "--config_exp", exp,
                      "--device", "cpu"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four stages of each CLI, each in its own root."""
    out = {}
    root = str(tmp_path_factory.mktemp("jax"))
    env, exp = _write_cfg(root)
    for stage in STAGES:
        jcli.main([stage, "--config_env", env, "--config_exp", exp])
    out["jax"] = (root, jcli.run_eval(j_create_config(env, exp)))
    root = str(tmp_path_factory.mktemp("port"))
    env, exp = _write_cfg(root)
    for stage in STAGES:
        _port(stage, env, exp)
    out["port"] = (root, _port("eval", env, exp))
    return out


def _base(root):
    return os.path.join(root, "out", "synthetic")


def _model(root, stage):
    (path,) = glob.glob(os.path.join(_base(root), stage, "model-*"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def _rel(a: dict, b: dict) -> float:
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
              for k in b)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


def _listing(root):
    base = _base(root)
    return sorted(os.path.relpath(os.path.join(d, n), base)
                  for d, _, names in os.walk(base) for n in names)


def test_artifacts_have_tpu_ac_layout(runs):
    jroot, _ = runs["jax"]
    troot, _ = runs["port"]
    assert _listing(troot) == _listing(jroot)
    for stage in ("pretext", "scan", "selflabel"):
        jmeta, jarr = _model(jroot, stage)
        tmeta, tarr = _model(troot, stage)
        assert tmeta["n_leaves"] == jmeta["n_leaves"]
        assert tmeta["dtypes"] == jmeta["dtypes"]
        assert tmeta["extra"].keys() == jmeta["extra"].keys()
        assert {k: v.shape for k, v in tarr.items()} == \
            {k: v.shape for k, v in jarr.items()}
    name = "top3-train-neighbors.npy"
    j = np.load(os.path.join(_base(jroot), name))
    t = np.load(os.path.join(_base(troot), name))
    assert t.dtype == j.dtype and t.shape == j.shape == (16, 4)


def test_eval_scores_equal(runs):
    assert runs["port"][1] == runs["jax"][1]


def test_pretext_models_within_1e2(runs):
    jarr = _model(runs["jax"][0], "pretext")[1]
    tarr = _model(runs["port"][0], "pretext")[1]
    assert _rel(tarr, jarr) < 1e-2


@pytest.fixture(scope="module")
def fed(runs, tmp_path_factory):
    """The port's scan, selflabel and eval stages, each fed by tpu_ac's
    artifacts of the stage before."""
    jbase = _base(runs["jax"][0])
    root = str(tmp_path_factory.mktemp("fed"))
    env, exp = _write_cfg(root)
    base = _base(root)
    os.makedirs(base)
    shutil.copytree(os.path.join(jbase, "pretext"),
                    os.path.join(base, "pretext"))
    shutil.copy(os.path.join(jbase, "top3-train-neighbors.npy"), base)
    _port("scan", env, exp)
    scan = _model(root, "scan")
    shutil.rmtree(os.path.join(base, "scan"))
    shutil.copytree(os.path.join(jbase, "scan"), os.path.join(base, "scan"))
    _port("selflabel", env, exp)
    selflabel = _model(root, "selflabel")
    shutil.rmtree(os.path.join(base, "selflabel"))
    shutil.copytree(os.path.join(jbase, "selflabel"),
                    os.path.join(base, "selflabel"))
    return {"scan": scan, "selflabel": selflabel,
            "eval": _port("eval", env, exp)}


def test_scan_stage_fed_by_tpu_ac(runs, fed):
    jmeta, jarr = _model(runs["jax"][0], "scan")
    tmeta, tarr = fed["scan"]
    assert tmeta["extra"] == jmeta["extra"]  # the same best head
    assert _rel(tarr, jarr) < 1e-3


def test_selflabel_stage_fed_by_tpu_ac(runs, fed):
    jarr = _model(runs["jax"][0], "selflabel")[1]
    assert _rel(fed["selflabel"][1], jarr) < 1e-5


def test_port_eval_of_tpu_ac_model(runs, fed):
    assert fed["eval"] == runs["jax"][1]


def test_tpu_ac_eval_of_port_model(runs):
    root, scores = runs["port"]
    assert jcli.run_eval(j_create_config(
        os.path.join(root, "env.yml"), os.path.join(root, "exp.yml"))) == \
        scores


def test_selflabel_reads_every_head_of_the_scan_model(runs,
                                                      tmp_path_factory):
    """The selflabel configs do not repeat num_heads (selflabel_cifar-10.
    yml has none); the reference reads every head of the SCAN checkpoint.
    tpu_ac builds its template from the selflabel config and refuses the
    2-head model (ROADMAP Queue 3); the port counts the heads in the
    checkpoint and keeps the best."""
    no_heads = EXP.replace("num_heads: 2\n", "")
    for name in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(f"heads_{name}"))
        env, exp = _write_cfg(root, no_heads)
        base = _base(root)
        os.makedirs(base)
        shutil.copytree(os.path.join(_base(runs[name][0]), "scan"),
                        os.path.join(base, "scan"))
        if name == "jax":
            with pytest.raises(ValueError, match="structure mismatch"):
                jcli.main(["selflabel", "--config_env", env,
                           "--config_exp", exp])
        else:
            _port("selflabel", env, exp)
            meta, arrays = _model(root, "selflabel")
            assert meta["n_leaves"] == _model(
                runs["port"][0], "selflabel")[0]["n_leaves"]
