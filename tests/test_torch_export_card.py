"""The serving export path on the card (``cuda`` tests; no tpu_ac import,
so the card's machine collects this file).  A tiny ViT exported on the
card: its programs, and scripts/serving_host_torch.py in a process of its
own, against the live port pipeline, exactly (the same ATen ops and the
same min_dists kernel on the same inputs), with the kernel's launches
counted and no plain call.  Run them with
``python -m pytest tests/test_torch_export_card.py -m cuda``."""

import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ac_torch.device import precision_scope
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.kernels import distances as tdist
from tpu_ac_torch.models.registry import BackboneSpec, register_backbone
from tpu_ac_torch.models.vit import ViTConfig
from tpu_ac_torch.pipeline import (
    PipelineConfig,
    build_embedder_for_config,
    compute_alpha_X,
)
from tpu_ac_torch.utils import export as texport

NAME = "tiny_torch_export_card"
HOST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "serving_host_torch.py")
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card_setup(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    register_backbone(NAME, BackboneSpec("vit", ViTConfig(
        patch_size=8, embed_dim=64, depth=2, num_heads=2, img_size=64),
        None))
    cfg = PipelineConfig(backbone_name=NAME, layers=("blocks.0", "blocks.1"),
                         pretrain_embed_dimension=96,
                         target_embed_dimension=192, imagesize=64,
                         batch_size=4, tau=1.0, precision="default")
    emb = build_embedder_for_config(cfg, device="cuda", mesh=None)
    d = tmp_path_factory.mktemp("card")
    params = {k: v.cpu().numpy() for k, v in emb._model.state_dict().items()}
    np.save(d / "params.npy", params, allow_pickle=True)
    # 20 images in a capacity of 32: both ranks of the dp artifact own
    # valid rows (a rank with none launches nothing)
    images = np.random.default_rng(0).integers(0, 255, (20, 3, 64, 64),
                                               dtype=np.uint8)
    np.save(d / "imgs.npy", images)
    return cfg, emb, d, images


def _live(emb, cfg, images, **kw):
    return compute_alpha_X(emb(images), cfg.supervised, cfg.tau,
                           precision=cfg.resolved_alpha_precision,
                           use_mesh=False, packed=True, **kw)


def test_programs_on_the_card_equal_live(card_setup):
    cfg, emb, d, images = card_setup
    path = texport.save_exported(
        str(d / "u.tpuac"),
        texport.export_category_programs(emb, cfg, n_images=20))
    progs = texport.load_exported(path, device="cuda")
    assert progs["meta"]["platforms"] == ["cuda"]
    params = dict(emb._model.state_dict())
    with precision_scope(cfg.precision), torch.inference_mode():
        z = torch.cat([progs["embed"](params, torch.from_numpy(
            images[i:i + 4]).cuda()) for i in range(0, 20, 4)])
    z_live = emb(images)
    assert torch.equal(z, z_live)
    before = (tdist.LAUNCHES, tdist.PLAIN_CALLS)
    zp = torch.cat([z, z.new_zeros(12, *z.shape[1:])])
    packed = progs["alpha_x"](zp, torch.tensor(20))[:20]
    assert (tdist.LAUNCHES, tdist.PLAIN_CALLS) == (before[0] + 1,
                                                   before[1])
    assert torch.equal(packed, _live(emb, cfg, images))


@pytest.mark.parametrize("case", ["unsupervised", "supervised", "dp2"])
def test_serving_host_on_the_card(card_setup, case):
    cfg, emb, d, images = card_setup
    extra, live_kw = [], {}
    if case == "supervised":
        cfg = dataclasses.replace(cfg, supervised="supervised")
        train = images[::-1].copy()
        np.save(d / "train.npy", train)
        extra = ["--train_images", str(d / "train.npy")]
        live_kw = {"Z_train": emb(train)}
    if case == "dp2":
        mesh_emb = build_embedder_for_config(cfg, device="cuda",
                                             mesh=Mesh(["cuda:0"] * 2))
        blob = texport.export_sharded_category_programs(mesh_emb, cfg,
                                                        n_images=20)
        extra = ["--devices", "cuda:0", "cuda:0"]
    else:
        blob = texport.export_category_programs(emb, cfg, n_images=20)
    path = texport.save_exported(str(d / f"{case}.tpuac"), blob)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, HOST, path, "--params", str(d / "params.npy"),
         "--images", str(d / "imgs.npy"), "--out", str(d / f"{case}.npz"),
         *extra], env=env, cwd=str(d), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    served = json.loads([ln for ln in proc.stdout.splitlines()
                         if ln.startswith('{"serving"')][-1])["serving"]
    want = (0, 2) if case == "dp2" else (1, 0)
    assert (served["launches"], served["window_launches"],
            served["plain_calls"]) == (*want, 0)
    out = np.load(d / f"{case}.npz")
    got = np.concatenate([out["alpha"], out["X"]], 1)
    if case == "dp2":  # no self-term: the sharded bands of the CPU tests
        a, x = compute_alpha_X(emb(images), "unsupervised", cfg.tau,
                               use_mesh=False)
        p = a.shape[1]
        np.testing.assert_allclose(got[:, :p], a.cpu(), rtol=2e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(got[:, p:], x.cpu(), rtol=2e-3,
                                   atol=1e-3)
    else:
        np.testing.assert_array_equal(
            got, _live(emb, cfg, images, **live_kw).cpu().numpy())
    if case == "unsupervised":
        # TF32 is a global switch, no part of a graph: the host set it
        # from meta["precision"], so its result is the TF32 embed's and
        # not the f32 one's
        f32 = build_embedder_for_config(
            dataclasses.replace(cfg, precision="highest"), device="cuda",
            mesh=None)
        assert not np.array_equal(
            got, _live(f32, cfg, images).cpu().numpy())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")


def _within(got, want, tol):
    """The kernel against the plain version, on squared distances to
    ``tol``: 1e-4 of |a|^2 + max|b|^2 (chip_smoke.py _check_agree gives
    the bound)."""
    assert bool(torch.isfinite(got).all())
    assert bool(((got.square() - want.square()).abs() <= tol).all())


def _tol(a, b):
    """[I, J, P] tolerance of the mins of a [I, P, D] against b [J, Q, D]."""
    return 1e-4 * (a.square().sum(-1)[:, None, :]
                   + b.square().sum(-1).amax(-1)[None, :, None])


@pytest.mark.parametrize("mode", ["symmetric", "rectangular", "window"])
@pytest.mark.parametrize("p,d", [(20, 96), (130, 4096)])
def test_ops_with_counts_match_plain_on_card(mode, p, d):
    """The ops in the form the exported programs give them: a padded
    capacity with the valid counts below it (symmetric: 6 of 8;
    rectangular: 6 of 8 rows against 3 of 4 bank images; window: the
    dp-2 rank at offset 4 of a bucket of 8 with 6 valid, its last rows and
    its wrapped columns masked).  The kernel agrees with the plain version
    on the valid entries, both leave the others +inf, and one call is one
    launch."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn(8, p, d, device="cuda", generator=gen)
    z[6:] = 0.0  # the bucket's padding rows
    before = (tdist.LAUNCHES, tdist.WINDOW_LAUNCHES)
    if mode == "window":
        off, n_local, h = 4, 4, 4
        b_idx = (off + 1 + torch.arange(n_local - 1 + h)) % 8
        kw = dict(window=h, row_valid=off + torch.arange(n_local) < 6,
                  col_valid=b_idx < 6)
        z_loc, bank_w = z[off:off + n_local], z[b_idx.cuda()]
        got = tdist.min_dists_window(z_loc, bank_w, **kw)
        assert (tdist.LAUNCHES, tdist.WINDOW_LAUNCHES) == (
            before[0], before[1] + 1)
        want = tdist.min_dists_window_plain(z_loc, bank_w, **kw)
        r = torch.arange(n_local)[:, None]
        w = torch.arange(bank_w.shape[0])[None, :]
        act = ((r <= w) & (w < r + h) & kw["row_valid"][:, None]
               & kw["col_valid"][None, :]).cuda()
        assert 0 < int(act.sum()) < int(((r <= w) & (w < r + h)).sum())
        for g, wnt, tol, m in ((got[0], want[0], _tol(z_loc, bank_w), act),
                               (got[1], want[1], _tol(bank_w, z_loc),
                                act.t())):
            assert bool(torch.isinf(g[~m]).all())
            assert bool(torch.isinf(wnt[~m]).all())
            _within(g[m], wnt[m], tol[m])
        return
    sym = mode == "symmetric"
    bank = z if sym else torch.randn(4, p, d, device="cuda", generator=gen)
    nb = 6 if sym else 3
    got = tdist.min_dists_all_pairs(z, bank, symmetric=sym, n_valid=6,
                                    n_bank_valid=None if sym else nb)
    assert (tdist.LAUNCHES, tdist.WINDOW_LAUNCHES) == (before[0] + 1,
                                                       before[1])
    want = tdist.min_dists_all_pairs_plain(z, bank, symmetric=sym,
                                           n_valid=6,
                                           n_bank_valid=None if sym else nb)
    assert got.shape == want.shape == (8, bank.shape[0], p)
    for t in (got, want):
        assert bool(torch.isinf(t[6:]).all())
        assert bool(torch.isinf(t[:, nb:]).all())
    _within(got[:6, :nb], want[:6, :nb], _tol(z[:6], bank[:nb]))


def test_host_alpha_x_runs_without_tf32():
    """scripts/serving_host_torch.py runs the alpha+X program with TF32
    off, as the live path does, whatever the process had set: its result
    is the program's under TF32 off, bit for bit, at the flagship's P and
    D.  (cuBLAS's [1, P] x [P, D] products of X gave the same bits with
    TF32 on at P = 784, D = 4096 and P = 3136, D = 1024 on an H100, so
    the switches themselves are held by tests/test_torch_export.py
    test_host_scopes_tf32_to_the_embed.)"""
    _needs_card()
    spec = importlib.util.spec_from_file_location("_host_under_test", HOST)
    host = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(host)
    saved = torch.backends.cuda.matmul.allow_tf32
    n, p, d = 32, 784, 4096
    try:
        z = torch.randn(n, p, d, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7))
        ep = torch.export.load(io.BytesIO(texport._export(
            texport.AlphaXProgram("unsupervised", 1.0, "f32"),
            (z, tdist.count_tensor(n, 0)))))
        torch.backends.cuda.matmul.allow_tf32 = False
        want = ep.module()(z, tdist.count_tensor(n - 2, 0))
        torch.backends.cuda.matmul.allow_tf32 = True
        served = host.alpha_x(host.Programs({"alpha_x": ep}),
                              {"supervised": "unsupervised"}, z, n - 2,
                              [torch.device("cuda:0")])
        assert torch.equal(served, want)
        assert torch.backends.cuda.matmul.allow_tf32  # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
