"""DINOv2's ViT with registers in tpu_ac_torch, on the CPU, against the
benchmark's plain reference (``benchmark/reference/dinov2-vitg14-reg.py``)
at a tiny size: width 64, 4 heads, 3 blocks, 4 registers, the SwiGLU's
hidden width by the release's rounding (176), a 5 x 5 position table
resized to the 4 x 4 grid of a 32 px image.  Weights are the benchmark's
draws (``harness/weights.py``) from the reference's ``param_spec``, the
products' weights scaled by ``WIDE`` = 5, about sqrt(1536 / 64): so the
products' outputs have the scale they have at ViT-g's width, where the
SwiGLU's gate is far from linear (at std 0.02 over a width of 64 silu(a)
is nearly a / 2, and swapping the halves would barely show).

Tolerance: both sides compute in f32 on the CPU; the port's patch
projection is a matmul where the reference convolves, its LayerNorm and
pooling are its own ops, so sums run in other orders: the port and the
reference differ by 5e-7 of the largest value.  ``TOL`` = 1e-4 of it
leaves that room 200 times over, and each planted fault moves the result
by more than ten times ``TOL`` (the resize without antialias by 3e-3: the
table is drawn at std 0.02 beside tokens of order 1; the others by 0.25
or more).

Also: the DINO ViTs (the 56 built-in names) keep their configs, their
inventories and their outputs, bit for bit; the resized table is cached
once a grid and follows a reloaded ``pos_embed`` and each tensor bound in
its place, also one at a freed tensor's address; the registry name and its
frozen inventory; ``cli.main`` at a size other than its default.
"""

import dataclasses
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

from benchmark.harness.weights import make_weights
from tpu_ac_torch.cli.main import build_parser
from tpu_ac_torch.cli.main import main as torch_main
from tpu_ac_torch.data.mvtec import make_synthetic_mvtec
from tpu_ac_torch.features import embedding as temb
from tpu_ac_torch.models import manifest as tman
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_jax_params

REF_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "reference",
    "dinov2-vitg14-reg.py")
ARCH = dict(patch_size=8, embed_dim=64, depth=3, num_heads=4, img_size=40,
            num_register_tokens=4)
TAPS = ("blocks.1", "blocks.2")
IMAGE = 32  # a 4 x 4 grid; the table is 5 x 5
TOL = 1e-4
SEED = 2 ** 33 + 19
WIDE = 5.0
PRODUCTS = ("attn.qkv.weight", "attn.proj.weight", "mlp.w12.weight",
            "mlp.w3.weight")


def _ref():
    spec = importlib.util.spec_from_file_location("ref_dinov2", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _ref()


def _config():
    cfg = tvit.DINOv2Config(**ARCH)
    arch = {**ARCH, "mlp_ratio": cfg.mlp_ratio, "ln_eps": cfg.ln_eps,
            "ffn_hidden": cfg.ffn_hidden}
    return cfg, {"arch": arch, "layers": list(TAPS),
                 "layerscale_draw": [0.5, 0.1]}


@pytest.fixture(scope="module")
def setup():
    cfg, conf = _config()
    weights = make_weights(REF.param_spec(conf), SEED, "cpu", torch.float32)
    weights = {k: v * WIDE if k.endswith(PRODUCTS) else v
               for k, v in weights.items()}
    torch.manual_seed(0)
    images = torch.randn(3, 3, IMAGE, IMAGE)
    with torch.no_grad():
        want = [m.flatten(2).transpose(1, 2)
                for m in REF.features(images, weights, conf, lambda t: t)]
    return cfg, conf, weights, images, want


def _model(cfg, weights):
    model = tvit.ViT(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def _port_taps(model, images):
    """The tapped blocks' patch tokens, the 5 prefix tokens dropped."""
    with torch.no_grad():
        outs = model(images, taps=(1, 2))
    return [outs[t][:, 5:] for t in (1, 2)]


def _gap(got, want):
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


def test_swiglu_hidden_and_inventory():
    cfg, conf = _config()
    assert cfg.ffn_hidden == 176 == REF.swiglu_hidden(conf)
    assert tvit.VIT_GIANT2_REG4.ffn_hidden == 4096
    model = tvit.ViT(cfg)
    keys = set(model.state_dict())
    assert {"register_tokens", "blocks.0.ls1.gamma", "blocks.0.ls2.gamma",
            "blocks.0.mlp.w12.weight", "blocks.0.mlp.w3.bias"} <= keys
    assert not any(".fc1." in k or ".fc2." in k for k in keys)
    assert keys == {n for n, *_ in REF.param_spec(conf)}
    assert model.state_dict()["blocks.2.mlp.w12.weight"].shape == (352, 64)


def test_taps_match_the_reference(setup):
    cfg, conf, weights, images, want = setup
    got = _port_taps(_model(cfg, weights), images)
    assert [g.shape for g in got] == [(3, 16, 64)] * 2
    assert _gap(got, want) < TOL


def test_embed_matches_the_reference(setup):
    """The whole embed: the taps with the 5 prefix tokens dropped and the
    anomaly-clustering tail, against the reference's features and tail."""
    from benchmark.reference.embedding import embed_tail

    cfg, conf, weights, images, _ = setup
    emb = temb.EmbedConfig(layers=TAPS, pretrain_embed_dimension=48,
                           target_embed_dimension=64)
    conf = {**conf, "patchsize": 3, "pretrain_embed_dimension": 48,
            "target_embed_dimension": 64}
    with torch.no_grad():
        got = temb.embed_vit_features(_model(cfg, weights), images, emb)
        want = embed_tail(REF.features(images, weights, conf, lambda t: t),
                          conf, lambda t: t)
    assert got.shape == want.shape == (3, 16, 64)
    assert _gap([got], [want]) < TOL


def _swapped_gate(self, x):
    b, a = self.w12(x).chunk(2, dim=-1)
    return self.w3(torch.nn.functional.silu(a) * b)


def _registers_last(self, images):
    b = images.shape[0]
    x = self.patch_embed.proj(images)
    x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
    x = x + self.pos_table(images.shape[2], images.shape[3])
    return torch.cat([x, self.register_tokens.expand(b, -1, -1)], dim=1)


def _no_antialias(pos_embed, npatch, h, w, cfg):
    g = pos_embed[:, 1:]
    side = int(round(g.shape[1] ** 0.5))
    grid = g.reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = torch.nn.functional.interpolate(
        grid, size=(h // cfg.patch_size, w // cfg.patch_size),
        mode="bicubic", antialias=False)
    return torch.cat([pos_embed[:, :1],
                      grid.permute(0, 2, 3, 1).reshape(1, npatch, -1)], 1)


@pytest.mark.parametrize("fault", ["gate_swapped", "registers_last",
                                   "resize_without_antialias",
                                   "layerscale_dropped"])
def test_comparison_catches_planted_faults(setup, fault, monkeypatch):
    cfg, conf, weights, images, want = setup
    model = _model(cfg, weights)
    if fault == "gate_swapped":
        monkeypatch.setattr(tvit._SwiGLU, "forward", _swapped_gate)
    elif fault == "registers_last":
        monkeypatch.setattr(tvit.ViT, "prepare_tokens", _registers_last)
    elif fault == "resize_without_antialias":
        monkeypatch.setattr(tvit, "interpolate_pos_encoding", _no_antialias)
    else:
        model.blocks[1].ls2 = None
    assert _gap(_port_taps(model, images), want) > 10 * TOL


def test_resized_table_cached_once_a_grid_and_follows_a_reload(setup):
    cfg, conf, weights, images, want = setup
    model = _model(cfg, weights)
    n0 = tvit.POS_EMBED_RESIZES
    first = _port_taps(model, images)
    _port_taps(model, images[:1])
    assert tvit.POS_EMBED_RESIZES - n0 == 1
    with torch.no_grad():  # the pretraining grid: the table as it is
        model(torch.randn(1, 3, 40, 40), taps=(0,))
    assert tvit.POS_EMBED_RESIZES - n0 == 1
    other = dict(weights)
    other["pos_embed"] = weights["pos_embed"] * -2.0 + 0.5
    fresh = _port_taps(_model(cfg, other), images)
    model.load_state_dict(other, strict=True)
    got = _port_taps(model, images)
    assert tvit.POS_EMBED_RESIZES - n0 == 3  # the fresh model's and this
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  torch.cat(fresh).numpy())
    assert _gap(got, first) > 10 * TOL
    # a gradient that reaches the table resizes it anew every forward
    model.pos_embed.requires_grad_(True)
    model(images, taps=(0,))[0].sum().backward()
    assert model.pos_embed.grad is not None
    assert tvit.POS_EMBED_RESIZES - n0 == 4


def _with_pos_embed(model, pe, images):
    """The taps with ``pe`` bound in place of ``pos_embed``, as
    ``DINOModel.bound`` binds a step's tensors."""
    saved = model._parameters["pos_embed"]
    model._parameters["pos_embed"] = pe
    try:
        return torch.cat(_port_taps(model, images))
    finally:
        model._parameters["pos_embed"] = saved


def test_resized_table_follows_each_bound_tensor(setup):
    """Two distinct tensors of one shape bound in turn each get their own
    table; so does a tensor at the address and version of one bound
    before (the allocator hands a freed step's memory to the next step's
    tensors), which an address and a version alone would take for it."""
    cfg, conf, weights, images, _ = setup
    model = _model(cfg, weights)
    pe = weights["pos_embed"]
    a, b = pe.clone(), pe * -2.0 + 0.5
    want = {}
    for name, t in (("a", a), ("b", b)):
        want[name] = torch.cat(_port_taps(_model(cfg, {**weights,
                                                        "pos_embed": t}),
                                          images))
    assert _gap([want["a"]], [want["b"]]) > 10 * TOL
    for name, t in (("a", a), ("b", b), ("a", a), ("b", b)):
        np.testing.assert_array_equal(_with_pos_embed(model, t, images),
                                      want[name])
    # c shares a's storage, with a version counter of its own
    c = torch.empty(0).set_(a.untyped_storage(), a.storage_offset(),
                            a.shape, a.stride())
    while a._version < c._version + 1:
        a.mul_(1.0)
    while c._version + 1 < a._version:
        c.mul_(1.0)
    version = a._version
    _with_pos_embed(model, a, images)
    c.copy_(b)
    assert c.data_ptr() == a.data_ptr() and c._version == version
    np.testing.assert_array_equal(_with_pos_embed(model, c, images),
                                  want["b"])


def _parent_forward(model, images, taps):
    """The DINO ViT's forward as the port ran it before DINOv2's parts:
    the table resized in the forward, no LayerScale, the GELU MLP."""
    b, _, h, w = images.shape
    x = model.patch_embed.proj(images)
    prefix = [model.cls_token.expand(b, -1, -1)]
    if model.cfg.num_prefix_tokens > 1:
        prefix.append(model.dist_token.expand(b, -1, -1))
    x = torch.cat(prefix + [x], dim=1)
    x = x + tvit.interpolate_pos_encoding(
        model.pos_embed, x.shape[1] - model.cfg.num_prefix_tokens, h, w,
        model.cfg)
    out = {}
    for i in range(max(taps) + 1):
        blk = model.blocks[i]
        x = x + blk.attn(blk.norm1(x))
        x = x + blk.mlp.fc2(torch.nn.functional.gelu(
            blk.mlp.fc1(blk.norm2(x)), approximate="none"))
        if i in taps:
            out[i] = x
    return out


def _dino_vit(name):
    """A tiny DINO ViT (``tiny``, ``tiny_dist`` with DeiT's dist token) or
    the registry's ``dino_vitbase8`` (its widths, weights drawn small)."""
    if name == "dino_vitbase8":
        model = treg.build_on_meta(name).to_empty(device="cpu")
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for t in model.parameters():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
        return model.eval()
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=64, depth=3, num_heads=4,
                         img_size=32,
                         num_prefix_tokens=2 if name == "tiny_dist" else 1)
    return load_jax_params(tvit.ViT(cfg),
                           tvit.init_vit_params(5, cfg)).eval()


@pytest.mark.parametrize("name,size", [
    ("tiny", 32), ("tiny", 48), ("tiny_dist", 48), ("dino_vitbase8", 32),
    ("dino_vitbase8", 48)])
def test_dino_vit_unchanged_bit_for_bit(name, size):
    """A DINO ViT (plain ``ViTConfig``) keeps DINO's inventory and runs
    the same ops in the same order: equal to the forward it had, at the
    pretraining size and at a resized grid (cached or not), with and
    without DeiT's dist token, and at ViT-B/8's widths (small images:
    the blocks are the same ops at any grid)."""
    model = _dino_vit(name)
    assert not any(k.startswith(("register", "mask")) or ".ls" in k or
                   ".w12" in k for k in model.state_dict())
    images = torch.randn(2, 3, size, size,
                         generator=torch.Generator().manual_seed(size))
    with torch.no_grad():
        want = _parent_forward(model, images, (1, 2))
        for _ in range(2):  # the second forward takes the cached table
            got = model(images, taps=(1, 2))
            for t in (1, 2):
                assert torch.equal(got[t], want[t])


def test_builtin_names_keep_dino_configs():
    """The 56 names that tpu_ac shares keep its plain ``ViTConfig`` (whose
    fields are tpu_ac's: DINOv2's parts are class attributes), and the
    port-only name is not among them."""
    assert len(treg.BUILTIN_BACKBONES) == 56
    assert set(treg.PORT_BACKBONES).isdisjoint(treg.BUILTIN_BACKBONES)
    fields = {f.name for f in dataclasses.fields(tvit.ViTConfig)}
    assert fields.isdisjoint({"ffn_layer", "layerscale",
                              "num_register_tokens",
                              "interpolate_antialias"})
    for name in treg.BUILTIN_BACKBONES:
        spec = treg.BACKBONE_CONFIGS[name]
        if spec.family == "vit":
            assert type(spec.config) is tvit.ViTConfig, name
            assert spec.config.ffn_layer == "mlp"
            assert spec.config.num_register_tokens == 0
            assert not spec.config.layerscale


def test_registry_row_and_frozen_inventory():
    spec = treg.BACKBONE_CONFIGS["dinov2_vitg14_reg"]
    c = spec.config
    assert (spec.family, spec.checkpoint) == (
        "vit", "dinov2_vitg14_reg4_pretrain.pth")
    assert (c.embed_dim, c.depth, c.num_heads, c.patch_size, c.img_size,
            c.num_register_tokens, c.ffn_hidden, c.layerscale,
            c.interpolate_antialias, c.interpolate_offset) == (
        1536, 40, 24, 14, 518, 4, 4096, True, True, 0.0)
    frozen = tman.load_manifests(tman.PORT_MANIFEST_PATH)
    assert sorted(frozen) == sorted(treg.PORT_BACKBONES)
    inv = tman.generate_manifest("dinov2_vitg14_reg")
    assert inv == frozen["dinov2_vitg14_reg"]
    assert len(inv) == 567
    assert sum(int(np.prod(s)) for s in inv.values()) == 1_136_485_376
    # the release's mask_token is ignored: it is no key of the module
    report = tman.verify_checkpoint({**{k: np.zeros(s) for k, s in
                                        inv.items()},
                                     "mask_token": np.zeros((1, 1536))},
                                    "dinov2_vitg14_reg")
    assert report == {"missing": [], "unexpected": ["mask_token"],
                      "shape_mismatch": []}


def test_cli_sizes_default_and_non_default(tmp_path):
    args = build_parser().parse_args([])
    assert (args.resize, args.imagesize) == (256, 224)
    name = "tiny_dinov2_cli"
    treg.register_backbone(name, treg.BackboneSpec(
        "vit", tvit.DINOv2Config(**ARCH), None))
    try:
        root = str(tmp_path / "mvtec")
        make_synthetic_mvtec(root, classname="bottle", n_per_anomaly=3,
                             image_size=64, seed=1)
        out = str(tmp_path / "out")
        torch_main(["--path", root, "--output_dir", out,
                    "--backbone_names", name,
                    "--layers_to_extract_from", *TAPS,
                    "--pretrain_embed_dimension", "48",
                    "--target_embed_dimension", "64",
                    "--categories", "bottle", "--batch_size", "4",
                    "--precision", "highest", "--device", "cpu",
                    "--resize", "56", "--imagesize", "48"])
        path = os.path.join(out, "mvtec_ad", name, "unsupervised",
                            "blocks.1_blocks.2_48_64_1.0_1.0",
                            "matrix_alpha_X_bottle_unsupervised.pickle")
        with open(path, "rb") as f:
            alpha, x = pickle.load(f)
        # 48 px at patch 8: a 6 x 6 grid, the table resized from 5 x 5
        assert alpha.shape == (9, 1, 36) and x.shape == (9, 64)
        assert np.isfinite(x).all()
        np.testing.assert_allclose(alpha.sum(-1), 1.0, rtol=1e-5)
    finally:
        treg.BACKBONE_CONFIGS.pop(name, None)
