"""tpu_ac_torch.utils.export (torch.export of the embed and alpha+X
programs, min_dists as a ``tpu_ac_torch`` custom op) and
scripts/serving_host_torch.py on the CPU.

The port's artifact is held two ways: against the live port pipeline
exactly (the same ops on the same inputs), and against ``tpu_ac``'s
artifact (jax.export) from the same params and images, at
tests/test_torch_pipeline.py's tolerances: alpha rtol 1e-3, atol 5e-4 (the
self-term floor of the kernel arithmetic, which differs by summation order,
carried through the softmax); X rtol 1e-3 with an atol of 1e-3 x max|X|
(X = alpha @ Z sums that gap over the patches).  Z is held to 1e-5
relative L2 (both f32 on the CPU; XLA and PyTorch sum in other orders).
The sharded artifacts (dp = 2) leave out the self-term that the
single-device sweep sums; against the single-device pipeline they are held
to tests/test_export.py's sharded bands (alpha rtol 2e-3, atol 5e-4; X
rtol 2e-3, atol 1e-3).  The tiny ViT is tests/test_export.py's (patch 8,
width 32, depth 2, 32 px, batch 4), registered in both registries under one
name (the same seeded init, so one params dict feeds both).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_ac.distributed import get_mesh as jax_get_mesh
from tpu_ac.models.registry import BackboneSpec as JSpec
from tpu_ac.models.registry import register_backbone as jax_register
from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac.pipeline import PipelineConfig as JConfig
from tpu_ac.pipeline import build_embedder_for_config as jax_build
from tpu_ac.utils import export as jexport
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.kernels import distances as tdist
from tpu_ac_torch.models.registry import BackboneSpec as TSpec
from tpu_ac_torch.models.registry import register_backbone as torch_register
from tpu_ac_torch.models.vit import ViTConfig as TViTConfig
from tpu_ac_torch.pipeline import PipelineConfig, build_embedder_for_config
from tpu_ac_torch.pipeline import compute_alpha_X
from tpu_ac_torch.utils import export as texport

NAME = "tiny_torch_export"
VIT = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
CFG = dict(backbone_name=NAME, layers=("blocks.0", "blocks.1"),
           pretrain_embed_dimension=48, target_embed_dimension=96,
           imagesize=32, batch_size=4, tau=1.0)
ALPHA_TOL = dict(rtol=1e-3, atol=5e-4)
SHARDED_ALPHA_TOL = dict(rtol=2e-3, atol=5e-4)
SHARDED_X_TOL = dict(rtol=2e-3, atol=1e-3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(ROOT, "scripts", "serving_host_torch.py")
OPS = {"unsupervised": "min_dists_symmetric",
       "supervised": "min_dists_rectangular"}


def _x_tol(x):
    return dict(rtol=1e-3, atol=1e-3 * float(np.abs(x).max()))


@pytest.fixture(scope="module")
def setup():
    jax_register(NAME, JSpec("vit", JViTConfig(**VIT), None))
    torch_register(NAME, TSpec("vit", TViTConfig(**VIT), None))
    cfg = PipelineConfig(**CFG)
    emb = build_embedder_for_config(cfg, device="cpu", mesh=None)
    params = {k: v.numpy() for k, v in emb._model.state_dict().items()}
    return cfg, emb, params


@pytest.fixture(scope="module")
def artifacts(setup, tmp_path_factory):
    """Both modes exported by the port; the supervised one with its own
    train capacity."""
    cfg, emb, _ = setup
    d = tmp_path_factory.mktemp("artifacts")
    out = {}
    for mode, extra in (("unsupervised", {}),
                        ("supervised", {"n_train_images": 40})):
        c = dataclasses.replace(cfg, supervised=mode)
        out[mode] = texport.save_exported(
            str(d / f"{mode}.tpuac"),
            texport.export_category_programs(emb, c, n_images=8, **extra))
    return out


@pytest.fixture(scope="module")
def jax_artifacts(setup, tmp_path_factory):
    """tpu_ac's artifacts of the same tiny ViT (its seeded init equals the
    port's params): unsupervised and supervised, single-device."""
    cfg, _, _ = setup
    jemb = jax_build(JConfig(**CFG), mesh=None)
    d = tmp_path_factory.mktemp("jax_artifacts")
    out = {}
    for mode, extra in (("unsupervised", {}),
                        ("supervised", {"n_train_images": 40})):
        c = dataclasses.replace(JConfig(**CFG), supervised=mode)
        out[mode] = jexport.save_exported(
            str(d / f"{mode}.tpuac"),
            jexport.export_category_programs(jemb, c, n_images=8, **extra))
    return out


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 255, (n, 3, 32, 32),
                                                dtype=np.uint8)


def _embed(progs, params, images, bs=4):
    """The artifact's embed program over ``images``, the tail padded."""
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    pad = (-len(images)) % bs
    full = np.concatenate([images, np.zeros((pad, *images.shape[1:]),
                                            np.uint8)])
    return torch.cat([progs["embed"](params, torch.from_numpy(full[i:i + bs]))
                      for i in range(0, len(full), bs)])[:len(images)]


def _pad(z, cap):
    return torch.cat([z, z.new_zeros(cap - len(z), *z.shape[1:])])


def _count(n):
    return torch.tensor(n, dtype=torch.int64)


class TestRoundTrip:
    def test_unsupervised_equals_live_pipeline(self, setup, artifacts):
        cfg, emb, params = setup
        progs = texport.load_exported(artifacts["unsupervised"])
        meta = progs["meta"]
        assert meta["n_images_capacity"] == 32  # 8 -> 32-bucket
        assert meta["supervised"] == "unsupervised"
        assert meta["image_dtype"] == "uint8"
        assert meta["platforms"] == ["cpu"]
        images = _images(0, 6)  # one full batch of 4 + a padded tail
        z_live = emb(images)
        z = _embed(progs, params, images)
        assert torch.equal(z, z_live)
        packed = progs["alpha_x"](_pad(z, 32), _count(6))[:6]
        live = compute_alpha_X(z_live, "unsupervised", cfg.tau,
                               precision=cfg.resolved_alpha_precision,
                               use_mesh=False, packed=True)
        assert torch.equal(packed, live)

    def test_supervised_separate_train_capacity(self, setup, artifacts):
        cfg, _, _ = setup
        progs = texport.load_exported(artifacts["supervised"])
        meta = progs["meta"]
        assert meta["n_images_capacity"] == 32
        assert meta["n_train_capacity"] == 64  # 40 -> 32-bucket
        rng = np.random.default_rng(3)
        p, d = meta["n_patches"], meta["embed_dim"]
        Z = torch.from_numpy(rng.standard_normal((3, p, d)).astype(
            np.float32))
        Zt = torch.from_numpy(rng.standard_normal((40, p, d)).astype(
            np.float32))
        packed = progs["alpha_x"](_pad(Z, 32), _pad(Zt, 64), _count(3),
                                  _count(40))[:3]
        live = compute_alpha_X(Z, "supervised", cfg.tau, Z_train=Zt,
                               use_mesh=False, packed=True,
                               precision=cfg.resolved_alpha_precision)
        assert torch.equal(packed, live)


class TestAgainstTpuAc:
    @pytest.mark.parametrize("mode", ["unsupervised", "supervised"])
    def test_artifacts_agree(self, setup, artifacts, jax_artifacts, mode):
        """Both packages' artifacts on one params dict and one image set
        (N = 6, train 5): Z, then alpha and X."""
        _, _, params = setup
        tprogs = texport.load_exported(artifacts[mode])
        jprogs = jexport.load_exported(jax_artifacts[mode])
        images, train = _images(1, 6), _images(2, 5)
        jz = np.concatenate([np.asarray(jprogs["embed"](
            params, np.concatenate([images, images[:2]])[i:i + 4]))
            for i in (0, 4)])[:6]
        tz = _embed(tprogs, params, images)
        assert float(np.linalg.norm(tz.numpy() - jz)
                     / np.linalg.norm(jz)) <= 1e-5
        zp = np.zeros((32, *jz.shape[1:]), np.float32)
        zp[:6] = jz
        if mode == "supervised":
            jzt = np.concatenate([np.asarray(jprogs["embed"](
                params, np.concatenate([train, train[:3]])[i:i + 4]))
                for i in (0, 4)])[:5]
            ztp = np.zeros((64, *jz.shape[1:]), np.float32)
            ztp[:5] = jzt
            want = np.asarray(jprogs["alpha_x"](zp, ztp, np.int32(6),
                                                np.int32(5)))[:6]
            got = tprogs["alpha_x"](torch.from_numpy(zp),
                                    torch.from_numpy(ztp), _count(6),
                                    _count(5))[:6].numpy()
        else:
            want = np.asarray(jprogs["alpha_x"](zp, np.int32(6)))[:6]
            got = tprogs["alpha_x"](torch.from_numpy(zp),
                                    _count(6))[:6].numpy()
        p = tprogs["meta"]["n_patches"]
        np.testing.assert_allclose(got[:, :p], want[:, :p], **ALPHA_TOL)
        np.testing.assert_allclose(got[:, p:], want[:, p:],
                                   **_x_tol(want[:, p:]))


class TestFormat:
    def test_version_gate_both_ways(self, artifacts, jax_artifacts,
                                    tmp_path):
        with pytest.raises(ValueError, match="unsupported export format 1"):
            texport.load_exported(jax_artifacts["unsupervised"])
        with pytest.raises(ValueError, match="unsupported export format"):
            jexport.load_exported(artifacts["unsupervised"])
        bad = tmp_path / "bad.tpuac"
        bad.write_bytes(pickle.dumps({"format_version": 999}))
        with pytest.raises(ValueError, match="format"):
            texport.load_exported(str(bad))

    @pytest.mark.parametrize("mode", ["unsupervised", "supervised"])
    def test_graph_holds_the_op(self, artifacts, mode):
        """The alpha program keeps the min_dists op as a node, not its
        decomposition; the artifact carries the ops' module and kernel."""
        with open(artifacts[mode], "rb") as f:
            blob = pickle.load(f)
        gm = texport.load_exported(artifacts[mode])["alpha_x"]
        targets = {str(n.target) for n in gm.graph.nodes
                   if n.op == "call_function"}
        assert f"tpu_ac_torch.{OPS[mode]}.default" in targets
        # none of the plain version's ops: its products and square roots
        assert not targets & {"aten.matmul.default", "aten.mm.default",
                              "aten.sqrt.default"}
        with open(tdist.__file__) as f:
            assert blob["ops_source"] == f.read()
        assert "tpu_ac_min_dists" in blob["kernel_source"]
        # one file: the shared header inlined in place of its include
        assert "mbar_wait" in blob["kernel_source"]
        assert '#include "hopper_common.cuh"' not in blob["kernel_source"]
        assert blob["kernel_library"] is None  # exported on the CPU

    def test_no_weights_in_the_artifact(self, setup, artifacts):
        """Params are inputs of the embed program; its only constants are
        the tail's (channel statistics, the pooling conv's averaging
        matrix), none equal to a parameter."""
        _, _, params = setup
        with open(artifacts["unsupervised"], "rb") as f:
            blob = pickle.load(f)
        import io

        ep = torch.export.load(io.BytesIO(blob["programs"]["cpu"]["embed"]))
        assert len(ep.state_dict) == 0
        user = [s.arg.name for s in ep.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
        assert len(user) == len(params) + 1  # every param, then the images
        consts = list(ep.constants.values())
        assert len(consts) == 3
        shapes = {tuple(v.shape) for v in params.values()}
        for c in consts:
            assert tuple(c.shape) not in shapes or not any(
                np.array_equal(c.numpy(), v) for v in params.values())
        assert sum(c.numel() for c in consts) * 4 < 0.5 * sum(
            v.nbytes for v in params.values())
        # nor anywhere else in the artifact (example inputs are not kept)
        with open(artifacts["unsupervised"], "rb") as f:
            raw = f.read()
        for k in ("pos_embed", "blocks.1.mlp.fc2.weight"):
            assert params[k].tobytes() not in raw


class TestRefusals:
    @pytest.mark.parametrize("case", ["mesh", "meshless", "flash",
                                      "average"])
    def test_refused(self, setup, case):
        cfg, emb, _ = setup
        if case == "mesh":
            mesh_emb = build_embedder_for_config(
                cfg, device="cpu", mesh=Mesh(["cpu"] * 2))
            with pytest.raises(ValueError, match="single-device"):
                texport.export_category_programs(mesh_emb, cfg, n_images=4)
        elif case == "meshless":
            with pytest.raises(ValueError, match="mesh"):
                texport.export_sharded_category_programs(emb, cfg,
                                                         n_images=4)
        elif case == "flash":
            flash = build_embedder_for_config(cfg, device="cpu", mesh=None,
                                              attention_impl="flash")
            with pytest.raises(NotImplementedError, match="item 19"):
                texport.export_category_programs(flash, cfg, n_images=4)
        else:
            acfg = dataclasses.replace(cfg, supervised="average")
            with pytest.raises(ValueError, match="not exportable"):
                texport.export_category_programs(emb, acfg, n_images=4)


@pytest.fixture(scope="module")
def sharded(setup, tmp_path_factory):
    """dp = 2 artifacts of both packages (tpu_ac on 2 of its 8 virtual
    devices, the port on Mesh(["cpu"] * 2)), batch 4."""
    cfg, _, _ = setup
    d = tmp_path_factory.mktemp("sharded")
    temb = build_embedder_for_config(cfg, device="cpu",
                                     mesh=Mesh(["cpu"] * 2))
    tpath = texport.save_exported(
        str(d / "torch.tpuac"),
        texport.export_sharded_category_programs(temb, cfg, n_images=8))
    jmesh = jax_get_mesh(2)
    jemb = jax_build(JConfig(**CFG), mesh=jmesh)
    jpath = jexport.save_exported(
        str(d / "jax.tpuac"),
        jexport.export_sharded_category_programs(jemb, JConfig(**CFG),
                                                 n_images=8))
    return tpath, jpath, jmesh


class TestSharded:
    def test_sharded_round_trip(self, setup, sharded):
        """The port's dp = 2 programs against the single-device pipeline
        (sharded bands), the live mesh path on the same padded Z (exactly)
        and tpu_ac's dp = 2 artifact (the pipeline tolerances)."""
        from tpu_ac_torch.cluster.alpha import (
            alpha_from_weights,
            weighted_embedding,
        )
        from tpu_ac_torch.distributed import (
            shard_batch,
            sharded_weight_distance_unsupervised,
        )

        cfg, emb, params = setup
        tpath, jpath, jmesh = sharded
        progs = texport.load_exported(tpath)
        meta = progs["meta"]
        assert meta["sharded"] and meta["n_devices"] == 2
        assert meta["n_images_capacity"] == 32 and meta["rank_kind"] == \
            "triangle"
        images = _images(4, 7)
        z = _embed(progs, params, images, bs=2)  # a shard of the batch
        assert float(torch.linalg.vector_norm(z - emb(images))
                     / torch.linalg.vector_norm(z)) <= 1e-5
        n, zp = 7, _pad(z, 32)
        parts = [progs["rank"](zp[r * 16:(r + 1) * 16], zp,
                               _count(r * 16), _count(n)) for r in range(2)]
        packed = progs["combine"](parts, zp, _count(n))[:n]
        p = meta["n_patches"]
        mesh = Mesh(["cpu"] * 2)
        w = torch.cat(sharded_weight_distance_unsupervised(
            mesh, shard_batch(mesh, zp)[0], n_valid=n))
        alpha = alpha_from_weights(w, cfg.tau)
        live = torch.cat([alpha, weighted_embedding(alpha, zp)], 1)[:n]
        assert torch.equal(packed, live)
        a1, x1 = compute_alpha_X(z, "unsupervised", cfg.tau, use_mesh=False)
        np.testing.assert_allclose(packed[:, :p], a1, **SHARDED_ALPHA_TOL)
        np.testing.assert_allclose(packed[:, p:], x1, **SHARDED_X_TOL)

        jprogs = jexport.load_exported(jpath)
        row_sh, repl = NamedSharding(jmesh, P("dp")), NamedSharding(jmesh,
                                                                    P())
        zp_np = zp.numpy()
        want = np.asarray(jprogs["alpha_x"](
            jax.device_put(zp_np, row_sh),
            jax.device_put(np.int32(n), repl)))[:n]
        np.testing.assert_allclose(packed[:, :p], want[:, :p], **ALPHA_TOL)
        np.testing.assert_allclose(packed[:, p:], want[:, p:],
                                   **_x_tol(want[:, p:]))

    def test_sharded_supervised(self, setup, tmp_path):
        cfg, _, _ = setup
        scfg = dataclasses.replace(cfg, supervised="supervised")
        temb = build_embedder_for_config(scfg, device="cpu",
                                         mesh=Mesh(["cpu"] * 2))
        progs = texport.load_exported(texport.save_exported(
            str(tmp_path / "sup.tpuac"),
            texport.export_sharded_category_programs(temb, scfg,
                                                     n_images=8)))
        meta = progs["meta"]
        assert meta["rank_kind"] == "min"
        gm = progs["rank"]
        assert "tpu_ac_torch.min_dists_rectangular.default" in {
            str(n.target) for n in gm.graph.nodes}
        rng = np.random.default_rng(1)
        p, d = meta["n_patches"], meta["embed_dim"]
        Z = torch.from_numpy(rng.standard_normal((5, p, d)).astype(
            np.float32))
        Zt = torch.from_numpy(rng.standard_normal((3, p, d)).astype(
            np.float32))
        zp, ztp = _pad(Z, 32), _pad(Zt, 32)
        rows = [progs["rank"](zp[r * 16:(r + 1) * 16], ztp, _count(3))
                for r in range(2)]
        packed = progs["combine"](rows, zp)[:5]
        a1, x1 = compute_alpha_X(Z, "supervised", cfg.tau, Z_train=Zt,
                                 use_mesh=False)
        np.testing.assert_allclose(packed[:, :p], a1, **SHARDED_ALPHA_TOL)
        np.testing.assert_allclose(packed[:, p:], x1, **SHARDED_X_TOL)


class TestCLI:
    def test_cli_end_to_end(self, setup, tmp_path, capsys):
        from tpu_ac_torch.cli.export import main

        _, _, params = setup
        out = str(tmp_path / "cli.tpuac")
        dump = str(tmp_path / "params.npy")
        common = ["--backbone_name", NAME,
                  "--layers_to_extract_from", "blocks.0", "blocks.1",
                  "--pretrain_embed_dimension", "48",
                  "--target_embed_dimension", "96", "--imagesize", "32",
                  "--batch_size", "4", "--n_images", "8", "--device", "cpu"]
        path = main([*common, "--output", out, "--dump_params", dump])
        assert path == out and out in capsys.readouterr().out
        progs = texport.load_exported(out)
        assert progs["meta"]["backbone_name"] == NAME
        dumped = np.load(dump, allow_pickle=True).item()
        assert dumped.keys() == params.keys()
        assert all(np.array_equal(dumped[k], params[k]) for k in params)
        z = _embed(progs, dumped, _images(3, 4))
        assert z.shape == (4, progs["meta"]["n_patches"],
                           progs["meta"]["embed_dim"])
        main([*common, "--output", str(tmp_path / "dp.tpuac"), "--dp", "2"])
        meta = texport.load_exported(str(tmp_path / "dp.tpuac"))["meta"]
        assert meta["sharded"] and meta["n_devices"] == 2


def _host(args, tmp_path):
    """scripts/serving_host_torch.py in a process whose sys.path holds no
    checkout (the host itself fails if a tpu_ac* module is loaded)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, HOST, *args, "--device", "cpu"],
                          env=env, cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=300)


class TestServingHost:
    def test_serves_unsupervised_like_the_live_pipeline(
            self, setup, artifacts, tmp_path):
        cfg, emb, params = setup
        np.save(tmp_path / "params.npy", params, allow_pickle=True)
        images = _images(7, 6)
        np.save(tmp_path / "imgs.npy", images)
        proc = _host([artifacts["unsupervised"], "--params",
                      str(tmp_path / "params.npy"), "--images",
                      str(tmp_path / "imgs.npy"), "--out",
                      str(tmp_path / "out.npz")], tmp_path)
        assert proc.returncode == 0, proc.stderr
        assert '"plain_calls": 1' in proc.stdout
        out = np.load(tmp_path / "out.npz")
        live = compute_alpha_X(emb(images), "unsupervised", cfg.tau,
                               use_mesh=False, packed=True).numpy()
        p = out["alpha"].shape[1]
        np.testing.assert_array_equal(out["alpha"], live[:, :p])
        np.testing.assert_array_equal(out["X"], live[:, p:])

    def test_serves_supervised_with_a_train_bank(self, setup, artifacts,
                                                 tmp_path):
        cfg, emb, params = setup
        np.save(tmp_path / "params.npy", params, allow_pickle=True)
        images, train = _images(13, 5), _images(14, 6)
        np.save(tmp_path / "imgs.npy", images)
        np.save(tmp_path / "train.npy", train)
        proc = _host([artifacts["supervised"], "--params",
                      str(tmp_path / "params.npy"), "--images",
                      str(tmp_path / "imgs.npy"), "--train_images",
                      str(tmp_path / "train.npy"), "--out",
                      str(tmp_path / "out.npz")], tmp_path)
        assert proc.returncode == 0, proc.stderr
        out = np.load(tmp_path / "out.npz")
        live = compute_alpha_X(emb(images), "supervised", cfg.tau,
                               Z_train=emb(train), use_mesh=False,
                               packed=True).numpy()
        p = out["alpha"].shape[1]
        np.testing.assert_array_equal(out["alpha"], live[:, :p])
        np.testing.assert_array_equal(out["X"], live[:, p:])

    def test_refuses_real_images_without_train(self, setup, artifacts,
                                               tmp_path):
        _, _, params = setup
        np.save(tmp_path / "params.npy", params, allow_pickle=True)
        np.save(tmp_path / "imgs.npy", _images(15, 5))
        proc = _host([artifacts["supervised"], "--params",
                      str(tmp_path / "params.npy"), "--images",
                      str(tmp_path / "imgs.npy"), "--out",
                      str(tmp_path / "out.npz")], tmp_path)
        assert proc.returncode != 0
        assert "train_images" in proc.stderr
        assert not (tmp_path / "out.npz").exists()

    def test_serves_sharded_on_a_virtual_mesh(self, setup, sharded,
                                              tmp_path):
        cfg, emb, params = setup
        np.save(tmp_path / "params.npy", params, allow_pickle=True)
        images = _images(11, 6)
        np.save(tmp_path / "imgs.npy", images)
        proc = _host([sharded[0], "--params", str(tmp_path / "params.npy"),
                      "--images", str(tmp_path / "imgs.npy"), "--out",
                      str(tmp_path / "out.npz"), "--devices", "cpu", "cpu"],
                     tmp_path)
        assert proc.returncode == 0, proc.stderr
        assert '"plain_calls": 2' in proc.stdout  # one window op a rank
        out = np.load(tmp_path / "out.npz")
        a1, x1 = compute_alpha_X(emb(images), "unsupervised", cfg.tau,
                                 use_mesh=False)
        np.testing.assert_allclose(out["alpha"], a1, **SHARDED_ALPHA_TOL)
        np.testing.assert_allclose(out["X"], x1, **SHARDED_X_TOL)


def _host_module():
    """scripts/serving_host_torch.py imported under a private name (its
    functions, not its main)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_host_under_test", HOST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _RecordingPrograms:
    """Programs whose calls record the TF32 switches they ran under."""

    def __init__(self, p, d, cap):
        self.seen = []
        self._p, self._d, self._cap = p, d, cap

    def on(self, name, device):
        def call(*args):
            self.seen.append((name, torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32))
            if name == "embed":
                return torch.zeros(args[1].shape[0], self._p, self._d)
            return torch.zeros(self._cap, self._p + self._d)
        return call


@pytest.mark.parametrize("precision,embed_tf32", [
    ("default", True), ("highest", False), ("bfloat16", True)])
def test_host_scopes_tf32_to_the_embed(precision, embed_tf32):
    """The serving host allows TF32 around the embed program's calls as
    the live embed's precision_scope does, and runs the alpha+X program
    with it off (the live path's full f32); the switches it found are
    restored."""
    host = _host_module()
    meta = {"n_images_capacity": 8, "supervised": "unsupervised",
            "batch_size": 4, "precision": precision, "n_patches": 3}
    progs = _RecordingPrograms(3, 5, 8)
    dev = torch.device("cpu")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for state in (False, True):  # whatever the process had set
            torch.backends.cuda.matmul.allow_tf32 = state
            torch.backends.cudnn.allow_tf32 = state
            progs.seen.clear()
            alpha, x = host.serve_category(progs, meta, {dev: {}},
                                           _images(1, 6), [dev])
            assert alpha.shape == (6, 3) and x.shape == (6, 5)
            assert progs.seen == [("embed", embed_tf32, embed_tf32)] * 2 \
                + [("alpha_x", False, False)]
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (state, state)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
