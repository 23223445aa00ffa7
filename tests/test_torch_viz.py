"""tpu_ac_torch.viz, ops.interpolate_nearest and the ViT's attention
forwards vs tpu_ac's, on the CPU, at 32 px with a tiny ViT (depth 2, dim
32, 2 heads, patch 8; the same seeded weights in both packages).

Bounds:
- ``interpolate_nearest``, the numpy helpers and every figure drawn from
  the same arrays: exactly equal (the decoded PNG pixels, the GIF frames);
- the attention maps: relative L2 within ``ATTN_BOUND`` of tpu_ac's at
  Precision.HIGHEST (f32 on both sides);
- the threshold masks of each package's attention: equal except where an
  element's cumulative mass lies within ``MASS_BOUND`` (plus the element's
  own mass, the most a reordered near-tie moves it) of 1 - threshold.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tpu_ac.cli import visualize_attention as jcli
from tpu_ac.data import mvtec as jmvtec
from tpu_ac.models import vit as jvit
from tpu_ac.ops import interpolate as jinterp
from tpu_ac.viz import plots as jplots
from tpu_ac.viz import video as jvideo
from tpu_ac_torch.cli import visualize_attention as tcli
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.ops import interpolate as tinterp
from tpu_ac_torch.viz import plots as tplots
from tpu_ac_torch.viz import video as tvideo

CFG = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
HW = 32
ATTN_BOUND = 1e-5
MASS_BOUND = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


@pytest.fixture(scope="module", params=[1, 2], ids=["cls", "distilled"])
def vits(request):
    """(tpu_ac params, tpu_ac cfg, port module) on one seeded init; 2
    prefix tokens is DeiT-distilled's CLS + dist."""
    jcfg = jvit.ViTConfig(**CFG, num_prefix_tokens=request.param)
    params = jvit.init_vit_params(0, jcfg)
    model = tvit.ViT(tvit.ViTConfig(**CFG, num_prefix_tokens=request.param))
    load_jax_params(model.to_empty(device="cpu"),
                    {k: np.asarray(v) for k, v in params.items()})
    return {k: jnp.asarray(v) for k, v in params.items()}, jcfg, \
        model.eval().requires_grad_(False)


def _images(seed, n=2, hw=(HW, HW)):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, *hw)).astype(np.float32)


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("in_size,out_size,sf", [
    (4, 32, None), (3, 32, None), (7, 24, None), (5, 3, None),
    (13, 13, None), (4, 30, 7.5), (6, 16, 8 / 3), (32, 4, 0.125)])
def test_nearest_tables_and_resize_equal(in_size, out_size, sf):
    want = jinterp._nearest_tables(in_size, out_size, sf)
    got = tinterp._nearest_tables(in_size, out_size, sf)
    np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(in_size).standard_normal(
        (2, 3, in_size, in_size + 1)).astype(np.float32)
    kw = dict(size=(out_size, out_size + 2)) if sf is None else \
        dict(scale_factor=(sf, sf))
    j = np.asarray(jinterp.interpolate_nearest(jnp.asarray(x), **kw))
    t = tinterp.interpolate_nearest(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(t, j)


# ------------------------------------------------------------- attention

def test_attention_forwards_match(vits):
    params, jcfg, model = vits
    x = _images(1)
    with torch.inference_mode():
        t_all = model.all_selfattentions(torch.from_numpy(x)).numpy()
        t_last = model.last_selfattention(torch.from_numpy(x)).numpy()
        t_idx = [model.index_selfattention(torch.from_numpy(x), i).numpy()
                 for i in range(CFG["depth"])]
    j_all = np.asarray(jvit.vit_all_selfattentions(params, jnp.asarray(x),
                                                   jcfg, HIGHEST))
    n = (HW // 8) ** 2 + jcfg.num_prefix_tokens
    assert t_all.shape == j_all.shape == (CFG["depth"], 2, 2, n, n)
    assert _rel(t_all, j_all) <= ATTN_BOUND
    np.testing.assert_allclose(t_all.sum(-1), 1.0, rtol=1e-5)
    for i in range(CFG["depth"]):
        j_i = np.asarray(jvit.vit_index_selfattention(
            params, jnp.asarray(x), jcfg, i, HIGHEST))
        assert _rel(t_idx[i], j_i) <= ATTN_BOUND
        # one forward gives every block's map: the same arithmetic
        np.testing.assert_array_equal(t_idx[i], t_all[i])
    np.testing.assert_array_equal(t_last, t_all[-1])
    with pytest.raises(ValueError, match="outside depth"):
        model.index_selfattention(torch.from_numpy(x), CFG["depth"])


def test_block_pair_and_flash_request_take_the_dense_path(vits):
    """(attention, output) from one evaluation; the output bit-equal to
    the plain block's, and "flash" with attention asked takes the dense
    path, as tpu_ac's block_forward does."""
    _, _, model = vits
    with torch.inference_mode():
        x = model.prepare_tokens(torch.from_numpy(_images(2)))
        blk = model.blocks[0]
        attn, out = blk(x, return_attention=True)
        attn_f, out_f = blk(x, "flash", return_attention=True)
        np.testing.assert_array_equal(out.numpy(), blk(x).numpy())
        np.testing.assert_array_equal(attn_f.numpy(), attn.numpy())
        np.testing.assert_array_equal(out_f.numpy(), out.numpy())
        # the embed path's taps: the blocks' outputs, unchanged
        taps = model(torch.from_numpy(_images(2)), (0, 1))
        np.testing.assert_array_equal(taps[0].numpy(), out.numpy())


def test_attention_maps_match(vits, tmp_path):
    params, jcfg, model = vits
    img = _images(3, n=1)[0]
    j = jplots.attention_maps(params, img, jcfg)
    t = tplots.attention_maps(model, img, save_dir=str(tmp_path),
                              device="cpu")
    assert t.shape == j.shape == (2, HW, HW)
    assert _rel(t, j) <= ATTN_BOUND
    assert sorted(os.listdir(tmp_path)) == ["attn-head0.png",
                                            "attn-head1.png"]


def test_attention_maps_of_a_frame_that_is_not_square(vits):
    """tpu_ac reshapes to a square isqrt(N) grid and raises here; the port
    takes the image's (H/p) x (W/p) grid, as the reference does."""
    params, jcfg, model = vits
    img = _images(4, n=1, hw=(HW, HW + 16))[0]
    with pytest.raises(TypeError):
        jplots.attention_maps(params, img, jcfg)
    attn = np.asarray(jvit.vit_last_selfattention(
        params, jnp.asarray(img[None]), jcfg, HIGHEST))
    cls = attn[0, :, 0, jcfg.num_prefix_tokens:].reshape(2, HW // 8,
                                                         (HW + 16) // 8)
    want = np.asarray(jinterp.interpolate_nearest(
        jnp.asarray(cls[None]), size=img.shape[1:]))[0]
    got = tplots.attention_maps(model, img, device="cpu")
    assert got.shape == (2, HW, HW + 16)
    assert _rel(got, want) <= ATTN_BOUND


def _masks_agree(got_attn, want_attn, threshold):
    """Element-wise mask equality outside the threshold band (module
    docstring); returns the number of elements inside the band."""
    got = tcli.threshold_masks(got_attn, threshold)
    want = jcli.threshold_masks(want_attn, threshold)
    share, cum = tcli.cumulative_mass(want_attn)
    band = np.abs(cum - (1 - threshold)) <= share + MASS_BOUND
    assert np.array_equal(got[~band], want[~band])
    return int(band.sum())


@pytest.mark.parametrize("threshold", [0.3, 0.6, 0.9])
def test_threshold_masks_of_each_packages_attention(vits, threshold):
    params, jcfg, model = vits
    x = _images(5)
    with torch.inference_mode():
        t = model.all_selfattentions(torch.from_numpy(x)).numpy()
    j = np.asarray(jvit.vit_all_selfattentions(params, jnp.asarray(x), jcfg,
                                               HIGHEST))
    skip = jcfg.num_prefix_tokens
    in_band = 0
    for b in range(CFG["depth"]):
        for i in range(2):
            in_band += _masks_agree(t[b, i, :, 0, skip:],
                                    j[b, i, :, 0, skip:], threshold)
    assert in_band <= CFG["depth"] * 2 * 2 * 2  # a pair a head at most


# --------------------------------------------------------- numpy helpers

def test_numpy_helpers_are_equal():
    rng = np.random.default_rng(7)
    att = rng.uniform(size=(3, 49)).astype(np.float32)
    for th in (0.1, 0.6, 0.99):
        np.testing.assert_array_equal(tcli.threshold_masks(att, th),
                                      jcli.threshold_masks(att, th))
    share, cum = tcli.cumulative_mass(att)
    np.testing.assert_allclose(share.sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(cum.max(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(np.argsort(cum, axis=1),
                                  np.argsort(att, axis=1))
    for shape, crop in (((40, 52, 3), (32, 32)), ((24, 20, 3), (32, 28)),
                        ((31, 33, 3), (31, 8))):
        arr = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(tcli._center_crop_2d(arr, *crop),
                                      jcli._center_crop_2d(arr, *crop))
    alpha = rng.uniform(size=36).astype(np.float32)
    for up in (1, 8):
        np.testing.assert_array_equal(tplots.alpha_heatmap(alpha, up),
                                      jplots.alpha_heatmap(alpha, up))
    z = rng.standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_array_equal(tplots.feature_map_grid(z),
                                  jplots.feature_map_grid(z))
    chw = rng.standard_normal((3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(tplots._denormalize(chw),
                                  jplots._denormalize(chw))
    m = rng.standard_normal((12, 20)).astype(np.float32)
    np.testing.assert_array_equal(tvideo._colorize(m), jvideo._colorize(m))
    frames = [rng.integers(0, 255, (37, 45, 3), dtype=np.uint8)
              for _ in range(2)]
    for resize in (None, 24):
        np.testing.assert_array_equal(
            tvideo.preprocess_frames(frames, 8, resize),
            jvideo.preprocess_frames(frames, 8, resize))
    np.testing.assert_array_equal(tplots.IMAGENET_MEAN, jmvtec.IMAGENET_MEAN)


# --------------------------------------------------------------- figures

def _both(fn_name, tmp_path, *args, **kw):
    """Call ``fn_name`` of both packages' plots with ``save_path`` in two
    directories; return the two paths."""
    paths = []
    for tag, mod in (("jax", jplots), ("torch", tplots)):
        p = str(tmp_path / tag / "fig.png")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        getattr(mod, fn_name)(*args, save_path=p, **kw)
        paths.append(p)
    return paths


def test_figures_from_the_same_arrays_are_pixel_equal(tmp_path):
    rng = np.random.default_rng(8)
    a, b = _both("visualize_alpha_on_image", tmp_path / "alpha",
                 rng.standard_normal((3, HW, HW)).astype(np.float32),
                 rng.uniform(size=16).astype(np.float32))
    np.testing.assert_array_equal(_pixels(a), _pixels(b))
    res = {1.0: {"bottle": (0.5, 0.4, 0.6), "cable": (0.3, 0.2, 0.4)},
           2.0: {"bottle": (0.6, 0.5, 0.7), "cable": (0.2, 0.1, 0.3)}}
    a, b = _both("draw_metrics", tmp_path / "draw", res, ["bottle", "cable"],
                 "ARI")
    np.testing.assert_array_equal(_pixels(a), _pixels(b))
    imgs = rng.integers(0, 255, (10, 16, 16, 3), dtype=np.uint8)
    a, b = _both("visualize_indices", tmp_path / "idx", imgs, [3, -1, 0, 9],
                 cols=3)
    np.testing.assert_array_equal(_pixels(a), _pixels(b))


def test_segmentation_and_feature_maps_are_pixel_equal(tmp_path):
    rng = np.random.default_rng(9)
    paths, masks = [], []
    for i in range(2):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 255, (HW, HW, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    m = str(tmp_path / "mask.png")
    Image.fromarray((rng.uniform(size=(HW, HW)) > 0.5).astype(np.uint8)
                    * 255).save(m)
    segs = rng.uniform(size=(2, HW, HW))
    Z = rng.standard_normal((4, 16, 8)).astype(np.float32)
    labels = ["good", "good", "crack", "hole"]
    images = rng.standard_normal((4, 3, HW, HW)).astype(np.float32)
    out = {}
    for tag, mod in (("jax", jplots), ("torch", tplots)):
        d = str(tmp_path / tag)
        mod.plot_segmentation_images(d, paths, segs, anomaly_scores=[0.2, 0.9],
                                     mask_paths=[None, m])
        fm = mod.feature_map_visualize(Z, labels, d, "vit", images_chw=images)
        out[tag] = (d, [os.path.basename(p) for p in fm])
    assert out["torch"][1] == out["jax"][1] == [
        "vit_good.png", "vit_crack.png", "vit_hole.png"]
    names = sorted(os.listdir(out["jax"][0]))
    assert sorted(os.listdir(out["torch"][0])) == names
    assert "segmentation_0001.png" in names
    for n in names:
        np.testing.assert_array_equal(
            _pixels(os.path.join(out["torch"][0], n)),
            _pixels(os.path.join(out["jax"][0], n)), err_msg=n)


def test_sweep_alpha_figures_are_pixel_equal(tmp_path):
    root = str(tmp_path / "mvtec")
    jmvtec.make_synthetic_mvtec(root, image_size=48, n_per_anomaly=2,
                                n_train=2)
    items = jmvtec.MVTecDataset(root, "bottle",
                                split=jmvtec.DatasetSplit.TEST).items
    alpha = np.random.default_rng(10).uniform(
        size=(len(items), 16)).astype(np.float32)
    saved = {}
    for tag, mod in (("jax", jplots), ("torch", tplots)):
        saved[tag] = mod.visualize_sweep_alpha(
            alpha, items, str(tmp_path / tag), resize=40, imagesize=32)
    names = [os.path.basename(p) for p in saved["jax"]]
    assert [os.path.basename(p) for p in saved["torch"]] == names
    assert len(names) == len({it.anomaly for it in items})
    for a, b in zip(saved["jax"], saved["torch"]):
        np.testing.assert_array_equal(_pixels(b), _pixels(a))


# ----------------------------------------------------------------- video

def test_video_frames_and_gif(vits, tmp_path):
    params, jcfg, model = vits
    frames = _images(11, n=3)
    for head in ("mean", 1):
        j = jvideo.render_attention_frames(params, frames, jcfg, head)
        t = tvideo.render_attention_frames(model, frames, head, "cpu")
        assert len(t) == len(j) == 3
        for a, b in zip(t, j):
            assert a.shape == (HW, HW) and _rel(a, b) <= ATTN_BOUND
    # the writer on the same heat maps: the same GIF frames
    gifs = [mod.write_video(j, str(tmp_path / f"{tag}.gif"), fps=5)
            for tag, mod in (("jax", jvideo), ("torch", tvideo))]
    ims = [Image.open(g) for g in gifs]
    assert ims[0].n_frames == ims[1].n_frames == 3
    for k in range(3):
        for im in ims:
            im.seek(k)
        np.testing.assert_array_equal(np.asarray(ims[1].convert("RGB")),
                                      np.asarray(ims[0].convert("RGB")))
    out = tvideo.generate_attention_video(model, frames,
                                          str(tmp_path / "attn.gif"), fps=5,
                                          device="cpu")
    assert Image.open(out).n_frames == 3


def test_extract_frames_equal(tmp_path):
    import cv2

    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                             (HW, HW))
    assert writer.isOpened()
    for f in np.random.default_rng(12).integers(0, 255, (4, HW, HW, 3)):
        writer.write(f.astype(np.uint8))
    writer.release()
    jf, jfps = jvideo.extract_frames_from_video(clip)
    tf, tfps = tvideo.extract_frames_from_video(
        clip, out_dir=str(tmp_path / "frames"))
    assert tfps == jfps and len(tf) == len(jf) == 4
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)
    assert len(os.listdir(tmp_path / "frames")) == 4

