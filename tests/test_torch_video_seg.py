"""DAVIS label propagation in both packages (tpu_ac.train.video_seg +
cli.eval_video_segmentation vs tpu_ac_torch's with --device cpu).

Equal: ``propagate_labels`` within 1e-5, including a case where every
source ties with the k-th (``aff >= kth`` keeps them all in both);
``propagate_video``'s masks within 1e-5; the neighbourhood masks, the
one-hots, the palette, ``read_frame`` (PARITY #19's std) and ``read_seg``
bit for bit; the CLI's indexed PNGs byte for byte on a synthetic DAVIS
tree (a non-square 2-object video at the default flags, and tpu_ac's own
test flags).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from tpu_ac.cli import eval_video_segmentation as jcli
from tpu_ac.models import registry as jreg
from tpu_ac.models.vit import ViTConfig as JViTConfig
from tpu_ac.train import video_seg as jvs
from tpu_ac_torch.cli import eval_video_segmentation as tcli
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models.vit import ViTConfig as TViTConfig
from tpu_ac_torch.train import video_seg as tvs

ARCH = "tiny_torch_videoseg"
CFG = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, img_size=32)


@pytest.fixture(scope="module", autouse=True)
def arch():
    jreg.register_backbone(ARCH, jreg.BackboneSpec("vit", JViTConfig(**CFG),
                                                   None))
    treg.register_backbone(ARCH, treg.BackboneSpec("vit", TViTConfig(**CFG),
                                                   None))


def _inputs(seed, n_ctx, grid, d=16, c=3, tie=False):
    rng = np.random.default_rng(seed)
    h, w = grid
    tar = rng.standard_normal((h * w, d)).astype(np.float32)
    ctx = rng.standard_normal((n_ctx, h * w, d)).astype(np.float32)
    if tie:  # every context frame the same: each source ties n_ctx times
        ctx[:] = ctx[0]
    segs = rng.random((n_ctx, c, h, w)).astype(np.float32)
    return tar, ctx, segs


@pytest.mark.parametrize("n_ctx,topk,size,tie", [
    (1, 5, 12, False), (3, 5, 1, False), (4, 3, 0, False), (3, 5, 2, True),
    (4, 4, 0, True)])
def test_propagate_labels_matches(n_ctx, topk, size, tie):
    grid = (5, 7)
    tar, ctx, segs = _inputs(n_ctx, n_ctx, grid, tie=tie)
    want = jvs.propagate_labels(jnp.asarray(tar), jnp.asarray(ctx),
                                jnp.asarray(segs), grid=grid, topk=topk,
                                size_mask_neighborhood=size)
    got = tvs.propagate_labels(torch.from_numpy(tar), torch.from_numpy(ctx),
                               torch.from_numpy(segs), grid=grid, topk=topk,
                               size_mask_neighborhood=size)
    assert got.shape == (3, *grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ties_keep_every_tied_source():
    """With n_ctx identical frames and topk = n_ctx, the k-th value is the
    top source's own: its n_ctx copies are kept, with equal weights, so
    the mask is the mean of the copies' labels at the top source."""
    grid = (4, 4)
    tar, ctx, segs = _inputs(1, 4, grid, tie=True)
    got = tvs.propagate_labels(torch.from_numpy(tar), torch.from_numpy(ctx),
                               torch.from_numpy(segs), grid=grid, topk=4,
                               size_mask_neighborhood=0).numpy()
    src = ctx[0] / np.linalg.norm(ctx[0], axis=1, keepdims=True)
    best = np.argmax(tar @ src.T, axis=1)
    flat = segs.reshape(4, 3, -1)
    want = flat[:, :, best].mean(axis=0).reshape(3, *grid)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_neighborhood_masks_equal():
    for h, w, s in ((5, 7, 1), (6, 4, 2), (3, 3, 12)):
        want = jvs.restrict_neighborhood(h, w, s)
        np.testing.assert_array_equal(tvs.restrict_neighborhood(h, w, s),
                                      want)
        np.testing.assert_array_equal(
            tvs._neighborhood_mask(h, w, s, torch.device("cpu")).numpy(),
            want)


def test_norm_mask_and_one_hot_equal():
    rng = np.random.default_rng(2)
    m = rng.random((3, 5, 6)).astype(np.float32)
    m[1] = 0.0  # an empty channel stays as it is
    np.testing.assert_array_equal(tvs.norm_mask(m), jvs.norm_mask(m))
    lab = rng.integers(0, 4, (5, 6))
    np.testing.assert_array_equal(tvs.to_one_hot(lab), jvs.to_one_hot(lab))
    np.testing.assert_array_equal(tvs.to_one_hot(lab, 6),
                                  jvs.to_one_hot(lab, 6))


@pytest.mark.parametrize("normalize", [True, False])
def test_propagate_video_matches(normalize):
    grid = (4, 6)
    rng = np.random.default_rng(3)
    frames = [rng.standard_normal((24, 16)).astype(np.float32)
              for _ in range(6)]
    first = tvs.to_one_hot(rng.integers(0, 3, grid))
    kw = dict(n_last_frames=2, topk=3, size_mask_neighborhood=2,
              normalize=normalize)
    want = jvs.propagate_video(frames, first, grid, **kw)
    got = tvs.propagate_video([torch.from_numpy(f) for f in frames], first,
                              grid, **kw)
    assert len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    """A DAVIS-2017 tree of two videos: "wide", 5 frames at 128 x 64 (w x
    h) with two objects moving apart; "square", tpu_ac's test video (3
    frames at 64 x 64, one bright square moving down)."""
    root = tmp_path_factory.mktemp("davis")
    sets = root / "ImageSets" / "2017"
    sets.mkdir(parents=True)
    rng = np.random.default_rng(0)
    pal = tcli.davis_palette().ravel().tolist()

    def video(name, n, hw, boxes):
        vid = root / "JPEGImages" / "480p" / name
        ann = root / "Annotations" / "480p" / name
        vid.mkdir(parents=True)
        ann.mkdir(parents=True)
        labels = np.zeros(hw, np.uint8)
        for t in range(n):
            arr = rng.integers(0, 40, (*hw, 3)).astype(np.uint8)
            for obj, (y, x, dy, dx, colour) in enumerate(boxes, 1):
                sl = np.s_[y + dy * t:y + dy * t + 20, x + dx * t:x + dx * t
                           + 20]
                arr[sl] = colour
                if t == 0:
                    labels[sl] = obj
            Image.fromarray(arr).save(vid / f"{t:05d}.jpg", quality=95)
        seg = Image.fromarray(labels)
        seg.putpalette(pal)
        seg.save(ann / "00000.png")

    video("wide", 5, (64, 128), [(8, 8, 4, 2, (230, 60, 60)),
                                 (30, 90, -3, 3, (60, 230, 200))])
    video("square", 3, (64, 64), [(16, 16, 8, 0, (230, 230, 230))])
    (sets / "val.txt").write_text("wide\nsquare\n")
    return str(root)


@pytest.mark.parametrize("flags", [
    ["--scale_size", "64", "--bs", "4"],
    ["--scale_size", "32", "32", "--n_last_frames", "2", "--topk", "2",
     "--size_mask_neighborhood", "1", "--bs", "2"]],
    ids=["defaults", "tpu_ac_test_flags"])
def test_cli_pngs_byte_equal(davis_root, tmp_path, flags):
    argv = ["--arch", ARCH, "--data_path", davis_root, *flags]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jw = jcli.main(argv + ["--output_dir", jout])
    tw = tcli.main(argv + ["--output_dir", tout, "--device", "cpu"])
    assert [os.path.relpath(p, tout) for p in tw] == \
        [os.path.relpath(p, jout) for p in jw]
    assert len(tw) == 8  # one PNG a frame
    for jp, tp in zip(jw, tw):
        with open(jp, "rb") as f, open(tp, "rb") as g:
            assert f.read() == g.read(), tp
        im = Image.open(tp)
        assert im.mode == "P"
    wide = np.asarray(Image.open(tw[4]))  # the last frame of "wide"
    assert wide.shape == (64, 128) and set(np.unique(wide)) <= {0, 1, 2}


def test_read_frame_and_seg_equal(davis_root):
    fp = os.path.join(davis_root, "JPEGImages", "480p", "wide", "00001.jpg")
    sp = os.path.join(davis_root, "Annotations", "480p", "wide",
                      "00000.png")
    for scale in ([48], [40, 40]):
        got, want = tcli.read_frame(fp, scale), jcli.read_frame(fp, scale)
        assert got[1:] == want[1:] == (64, 128)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(tcli.read_seg(sp, 8, scale),
                        jcli.read_seg(sp, 8, scale)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tcli.davis_palette(), jcli.davis_palette())


def test_cli_keeps_tpu_ac_flags():
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions}
    tflags = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert tflags.pop("device") == "cuda"
    assert tflags == jflags


def test_imwrite_indexed_rejects_3d(tmp_path):
    with pytest.raises(ValueError, match="2D"):
        tcli.imwrite_indexed(str(tmp_path / "x.png"),
                             np.zeros((2, 2, 2), np.uint8),
                             tcli.davis_palette())
