"""The ``ac.*`` ranges and the image counters of
``tpu_ac_torch.pipeline.run_category_sweep``, on the CPU: each range once a
category (``ac.embed``, ``ac.decode`` and ``ac.stage`` once more for the
train set when supervised), nested as the sweep's layers are, the prefetch
thread's ranges on a thread of their own, the counters at the tree's true
and padded counts, and a sweep's arrays the same under the profiler,
without it, and computed category by category.  Inside ``ac.embed`` each
batch opens ``ac.embed.trunk`` (the backbone) and ``ac.embed.tail`` (the
embedding tail), for a ViT and for a ResNet; the ViT's position table is
resized once a grid in a sweep of many batches
(``models.vit.POS_EMBED_RESIZES``)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_ac_torch import pipeline
from tpu_ac_torch.data.mvtec import (
    DatasetSplit,
    MVTecDataset,
    make_synthetic_mvtec,
)
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.models.registry import (
    BACKBONE_CONFIGS,
    BackboneSpec,
    load_backbone,
    register_backbone,
)
from tpu_ac_torch.models.resnet import ResNetConfig
from tpu_ac_torch.models.vit import ViT, ViTConfig
from tpu_ac_torch.utils.profiling import all_threads_config, maybe_profile

VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
EMBED_CFG = dict(layers=("blocks.0", "blocks.1"),
                 pretrain_embed_dimension=96, target_embed_dimension=192,
                 resize=36, imagesize=32, precision="highest", batch_size=8,
                 train_ratio=0.5)
# category -> test images a defect folder (3 folders: good and 2 defects);
# 12 and 9 test images pad to 16 each, 6 and 4 train images to 8 each
TREE = {"bottle": 4, "cable": 3}
SWEEP = ("ac.prefetch_wait", "ac.dispatch", "ac.embed", "ac.alpha",
         "ac.resolve", "ac.resolve_wait")
PREFETCH = ("ac.load", "ac.decode", "ac.stage")
# once an embed batch, inside ac.embed: 12 + 9 test images at batch 8
EMBED = ("ac.embed.trunk", "ac.embed.tail")
BATCHES = 2 + 2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mvtec"))
    for i, (cat, n) in enumerate(TREE.items()):
        make_synthetic_mvtec(root, classname=cat, n_per_anomaly=n,
                             image_size=48, seed=i)
    return root


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return ViT(ViTConfig(**VIT)).eval()


def _embedder(model, mode):
    cfg = pipeline.PipelineConfig(supervised=mode, **EMBED_CFG)
    return cfg, pipeline.CategoryEmbedder(model, cfg, device="cpu")


def _sweep(root, cfg, emb):
    return {c: (r["alpha"].copy(), r["X"].copy()) for c, r in
            pipeline.run_category_sweep(root, list(TREE), cfg, emb)}


def _ranges(prof):
    """[(name, start, end, thread)] of the trace's ``ac.*`` ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("ac.")]


def _inside(r, outer):
    return r[3] == outer[3] and outer[1] <= r[1] and r[2] <= outer[2]


@pytest.mark.parametrize("mode", ["unsupervised", "supervised"])
def test_ranges_once_a_category_and_nested(root, model, mode):
    cfg, emb = _embedder(model, mode)
    config = all_threads_config()
    kw = {} if config is None else {"experimental_config": config}
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        _sweep(root, cfg, emb)
    ranges = _ranges(prof)
    names = [r[0] for r in ranges]
    # fixed names: the category is never part of one
    assert set(names) <= set(SWEEP + PREFETCH + EMBED)
    sets = 2 if mode == "supervised" else 1
    for name in SWEEP:
        want = sets if name == "ac.embed" else 1
        assert names.count(name) == want * len(TREE), name
    by = {n: [r for r in ranges if r[0] == n] for n in set(names)}
    sweep_thread = by["ac.dispatch"][0][3]
    assert {r[3] for n in SWEEP for r in by[n]} == {sweep_thread}
    for inner, outer in (("ac.embed", "ac.dispatch"),
                         ("ac.alpha", "ac.dispatch"),
                         ("ac.resolve_wait", "ac.resolve")):
        for r in by[inner]:
            assert any(_inside(r, o) for o in by[outer]), (inner, r)
    if config is None:  # this torch records the profiling thread alone
        return
    assert names.count("ac.load") == len(TREE)
    assert names.count("ac.decode") == names.count("ac.stage") == \
        sets * len(TREE)
    for name in ("ac.decode", "ac.stage"):
        for r in by[name]:
            assert r[3] != sweep_thread
            assert any(_inside(r, o) for o in by["ac.load"]), (name, r)


@pytest.mark.parametrize("mode,decoded,embedded", [
    ("unsupervised", 12 + 9, 16 + 16),
    ("supervised", 12 + 9 + 6 + 4, 16 + 16 + 8 + 8)])
def test_counters_count_true_and_padded_images(root, model, mode, decoded,
                                               embedded):
    cfg, emb = _embedder(model, mode)
    d0, e0 = pipeline.IMAGES_DECODED, pipeline.IMAGES_EMBEDDED
    _sweep(root, cfg, emb)
    assert pipeline.IMAGES_DECODED - d0 == decoded
    assert pipeline.IMAGES_EMBEDDED - e0 == embedded


@pytest.mark.parametrize("mode", ["unsupervised", "supervised"])
def test_arrays_the_same_with_and_without_the_profiler(root, model, mode):
    cfg, emb = _embedder(model, mode)
    plain = _sweep(root, cfg, emb)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _sweep(root, cfg, emb)
    for cat in TREE:
        ds = MVTecDataset(root, classname=cat, resize=cfg.resize,
                          imagesize=cfg.imagesize, split=DatasetSplit.TEST)
        z = emb(ds.load_all_images())
        z_train = None
        if mode == "supervised":
            z_train = emb(pipeline._load_train_images(root, cat, cfg,
                                                       len(ds), 2023))
        alpha, x = pipeline.compute_alpha_X(
            z, mode, cfg.tau, z_train,
            precision=cfg.resolved_alpha_precision)
        for got in (plain[cat], traced[cat]):
            np.testing.assert_array_equal(got[0], alpha.numpy())
            np.testing.assert_array_equal(got[1], x.numpy())


def test_profile_trace_holds_both_threads_ranges(root, model, tmp_path):
    """``--profile``'s trace (``maybe_profile``) holds the sweep's ranges
    and, where this torch records every thread, the prefetch thread's."""
    cfg, emb = _embedder(model, "unsupervised")
    with maybe_profile(str(tmp_path)):
        _sweep(root, cfg, emb)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if e.get("name", "").startswith("ac."):
            tids.setdefault(e["name"], set()).add(e["tid"])
    assert set(SWEEP) <= set(tids)
    if all_threads_config() is not None:
        assert set(PREFETCH) <= set(tids)
        assert tids["ac.decode"].isdisjoint(tids["ac.dispatch"])


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_trunk_and_tail_nested_in_embed(root, model, family):
    if family == "vit":
        net = model
    else:
        name = "tiny_spans_resnet"
        register_backbone(name, BackboneSpec("resnet", ResNetConfig(
            block_counts=(1, 1, 1, 1), width_per_group=16, expansion=1,
            block="basic"), None))
        try:
            net = load_backbone(name)[0]
        finally:
            BACKBONE_CONFIGS.pop(name)
    cfg = pipeline.PipelineConfig(
        supervised="unsupervised",
        **{**EMBED_CFG, "layers": ("blocks.0", "blocks.1") if
           family == "vit" else ("layer2", "layer3")})
    emb = pipeline.CategoryEmbedder(net, cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep(root, cfg, emb)
    ranges = _ranges(prof)
    by = {n: [r for r in ranges if r[0] == n] for n in ("ac.embed",) + EMBED}
    assert len(by["ac.embed"]) == len(TREE)
    for name in EMBED:
        assert len(by[name]) == BATCHES, name
        for r in by[name]:
            assert any(_inside(r, o) for o in by["ac.embed"]), (name, r)
    # the tail of a batch starts after its trunk has ended
    for trunk, tail in zip(sorted(by[EMBED[0]], key=lambda r: r[1]),
                           sorted(by[EMBED[1]], key=lambda r: r[1])):
        assert trunk[2] <= tail[1]


def test_pos_table_resized_once_a_grid(root):
    """A table of 5 x 5 (40 px at patch 8) under a sweep of 4 batches at
    32 px and one at 48 px: one resize a grid, none in a second sweep."""
    vit = ViTConfig(**{**VIT, "img_size": 40})
    net = load_jax_params(ViT(vit), tvit.init_vit_params(0, vit)).eval()
    for imagesize in (32, 48):
        cfg = pipeline.PipelineConfig(
            supervised="unsupervised",
            **{**EMBED_CFG, "resize": imagesize + 4,
               "imagesize": imagesize})
        emb = pipeline.CategoryEmbedder(net, cfg, device="cpu")
        n0 = tvit.POS_EMBED_RESIZES
        _sweep(root, cfg, emb)
        assert tvit.POS_EMBED_RESIZES - n0 == 1
        _sweep(root, cfg, emb)
        assert tvit.POS_EMBED_RESIZES - n0 == 1
