"""The viz CLIs and the SCAN tutorial of both packages on one synthetic
input each, at 48 px with a tiny ViT registered under one name in both
registries (depth 2, dim 32, 2 heads, patch 8; no checkpoint, so both take
the seed-0 init, bit-identical):

- ``cli.visualize_attention`` with and without ``--threshold``, on an
  MVTec-style path so the ground-truth panel is drawn: the same files in
  the same order; ``img.png`` pixel-equal; the CLS rows of every block
  within ``ATTN_BOUND`` (relative L2) of tpu_ac's; the final block's
  masks equal outside the threshold band of ``test_torch_viz.py``, and
  their overlay PNGs pixel-equal where the masks are;
- ``cli.video_generation`` on a video file (mp4 through cv2) and on a
  directory of frames (GIF): the same file, the same frame count;
- ``cli.draw`` on a UTF-8 and a GBK CSV: the same line, pixel-equal PNGs;
- ``cli.evaluate --visualize`` on one stage-1 pickle: the same files under
  ``visualize/<run-name>/``, pixel-equal;
- ``tpu_ac_torch.tutorial`` against ``tutorial.py``: the same neighbour
  accuracy; the same neighbours in a row wherever its k-th and (k+1)-th
  similarities are apart by more than ``TIE``, in the same order where
  all its top k + 2 are (near-ties may order differently).
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from tpu_ac.cli import draw as jdraw
from tpu_ac.cli import evaluate as jeval
from tpu_ac.cli import video_generation as jvidcli
from tpu_ac.cli import visualize_attention as jvis
from tpu_ac.data import mvtec as jmvtec
from tpu_ac.models import registry as jreg
from tpu_ac.models import vit as jvit
from tpu_ac.pipeline import PipelineConfig, artifact_dir
from tpu_ac_torch.cli import draw as tdraw
from tpu_ac_torch.cli import evaluate as teval
from tpu_ac_torch.cli import video_generation as tvidcli
from tpu_ac_torch.cli import visualize_attention as tvis
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.train import scan as tscan

ARCH = "tiny_torch_vizcli"
CFG = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
HW = 48
ATTN_BOUND = 1e-5
MASS_BOUND = 1e-5
TIE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def arch():
    jreg.register_backbone(ARCH, jreg.BackboneSpec(
        "vit", jvit.ViTConfig(**CFG), None))
    treg.register_backbone(ARCH, treg.BackboneSpec(
        "vit", tvit.ViTConfig(**CFG), None))


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def _quiet(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def mvtec_image(tmp_path_factory):
    """(root, image path relative to it): the CLIs find the ground truth by
    replacing every "test" in the path, as the reference does, so the
    path they see holds none but the split's."""
    root = tmp_path_factory.mktemp("viz")
    img_dir = root / "bottle" / "test" / "broken"
    gt_dir = root / "bottle" / "ground_truth" / "broken"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 255, (64, 80, 3), dtype=np.uint8)
                    ).save(img_dir / "000.png")
    mask = np.zeros((64, 80), np.uint8)
    mask[20:40, 20:50] = 255
    Image.fromarray(mask).save(gt_dir / "000_mask.png")
    return str(root), os.path.join("bottle", "test", "broken", "000.png")


def _tpu_ac_cls_rows(image_path):
    """tpu_ac's CLS rows of every block, from its CLI's own preprocessing
    (visualize_attention.main up to the forward)."""
    params, cfg, _ = jreg.load_backbone(ARCH)
    img = Image.open(image_path).convert("RGB")
    arr = np.asarray(jmvtec._resize_shorter_edge(img, 256),
                     np.float32) / 255.0
    arr = jvis._center_crop_2d(arr, HW, HW)
    chw = ((arr - jmvtec.IMAGENET_MEAN) / jmvtec.IMAGENET_STD
           ).transpose(2, 0, 1)
    att = jvit.vit_all_selfattentions(params, jnp.asarray(chw[None]), cfg,
                                      jax.lax.Precision.HIGHEST)
    return np.asarray(att)[:, 0, :, 0, cfg.num_prefix_tokens:]


@pytest.mark.parametrize("threshold", [None, "0.6"])
def test_visualize_attention_cli(mvtec_image, tmp_path, threshold,
                                 monkeypatch):
    root, mvtec_image = mvtec_image
    monkeypatch.chdir(root)
    extra = [] if threshold is None else ["--threshold", threshold]
    common = ["--arch", ARCH, "--image_path", mvtec_image, "--image_size",
              str(HW), *extra]
    jw, _ = _quiet(jvis.main, common + ["--output_dir",
                                        str(tmp_path / "jax")])
    tw, _ = _quiet(tvis.main, common + ["--output_dir", str(tmp_path / "t"),
                                        "--device", "cpu"])
    names = [os.path.basename(p) for p in jw]
    assert [os.path.basename(p) for p in tw] == names
    want = ["img.png", "blocks.0_attn-head.png", "blocks.1_attn-head.png"]
    if threshold:
        want += ["mask_th0.6_head0.png", "mask_th0.6_head1.png"]
    assert names == want
    assert all(os.path.getsize(p) > 0 for p in tw)
    np.testing.assert_array_equal(_pixels(tw[0]), _pixels(jw[0]))

    model, _, _ = treg.load_backbone(ARCH)
    a = tvis.attention_arrays(model, mvtec_image, (HW, HW),
                              None if threshold is None else 0.6, "cpu")
    want_cls = _tpu_ac_cls_rows(mvtec_image)
    assert a["cls_attn"].shape == want_cls.shape == (2, 2, (HW // 8) ** 2)
    rel = np.linalg.norm(a["cls_attn"] - want_cls) / np.linalg.norm(want_cls)
    assert rel <= ATTN_BOUND
    assert a["maps"].shape == (2, 2, HW, HW)
    assert a["gt"].shape == (HW, HW, 3) and a["gt"].max() == 255
    if threshold is None:
        assert a["th_attn_up"] is None
        return
    got_m = tvis.threshold_masks(a["cls_attn"][-1], 0.6)
    want_m = jvis.threshold_masks(want_cls[-1], 0.6)
    share, cum = tvis.cumulative_mass(want_cls[-1])
    band = np.abs(cum - 0.4) <= share + MASS_BOUND
    assert np.array_equal(got_m[~band], want_m[~band])
    assert a["th_attn_up"].shape == (2, HW, HW)
    for j in range(2):
        if np.array_equal(got_m[j], want_m[j]):
            np.testing.assert_array_equal(_pixels(tw[3 + j]),
                                          _pixels(jw[3 + j]))


def _write_clip(path, n_frames=3, fps=8.0):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (HW, HW))
    assert writer.isOpened()
    rng = np.random.default_rng(3)
    for f in rng.integers(0, 255, (n_frames, HW, HW, 3)):
        writer.write(f.astype(np.uint8))
    writer.release()


def _frame_count(path):
    if path.endswith(".gif"):
        return Image.open(path).n_frames
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("source,fmt", [("file", "mp4"), ("dir", "gif")])
def test_video_generation_cli(tmp_path, source, fmt):
    if source == "file":
        src = tmp_path / "clip.mp4"
        _write_clip(src)
    else:
        src = tmp_path / "frames"
        src.mkdir()
        rng = np.random.default_rng(4)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (HW, HW, 3),
                                         dtype=np.uint8)).save(
                src / f"frame-{i:04d}.jpg")
    common = ["--input_path", str(src), "--arch", ARCH, "--video_format",
              fmt, "--head", "1"]
    jout, _ = _quiet(jvidcli.main, common + ["--output_path",
                                             str(tmp_path / "jax")])
    tout, line = _quiet(tvidcli.main, common + [
        "--output_path", str(tmp_path / "t"), "--device", "cpu"])
    assert os.path.basename(tout) == os.path.basename(jout) == f"video.{fmt}"
    assert line.strip() == f"Done: {tout}"
    assert _frame_count(tout) == _frame_count(jout) == 3


_CSV = ("unsupervised\nCategory,NMI,ARI,F1\n---,---,---,---\n"
        "TAU=1.0\nbottle,0.5,0.4,0.6\ncable,0.3,0.2,0.4\n"
        "MVTec(object),0.4,0.3,0.5\n"
        "TAU=2.0\nbottle,0.6,0.5,0.7\ncable,0.2,0.1,0.3\n"
        "MVTec(object),0.4,0.3,0.5\n")


@pytest.mark.parametrize("encoding", ["utf-8", "gbk"])
def test_draw_cli(tmp_path, encoding):
    csv_path = tmp_path / "tau_result.csv"
    csv_path.write_bytes(_CSV.encode(encoding))
    extra = ["--gbk"] if encoding == "gbk" else []
    lines, outs = [], []
    for tag, main in (("jax", jdraw.main), ("torch", tdraw.main)):
        out = str(tmp_path / f"{tag}_sweep.png")
        _, line = _quiet(main, [str(csv_path), "--metric", "F1", "--out",
                                out, *extra])
        lines.append(line.replace(out, "OUT"))
        outs.append(out)
    assert lines[0] == lines[1]
    assert "2 categories, 2 tau values" in lines[1]
    np.testing.assert_array_equal(_pixels(outs[1]), _pixels(outs[0]))


def test_evaluate_visualize(tmp_path):
    root = str(tmp_path / "mvtec")
    jmvtec.make_synthetic_mvtec(root, image_size=HW, n_per_anomaly=2,
                                n_train=2)
    n = len(jmvtec.MVTecDataset(root, "bottle",
                                split=jmvtec.DatasetSplit.TEST).items)
    rng = np.random.default_rng(5)
    alpha = rng.random((n, 1, 16)).astype(np.float32)
    x = rng.random((n, 8)).astype(np.float32)
    flags = ["--backbone_names", ARCH, "--layers_to_extract_from",
             "blocks.1", "--pretrain_embed_dimension", "8",
             "--target_embed_dimension", "8", "--tau_list", "1.0",
             "--supervised_modes", "unsupervised", "--categories",
             "bottle"]
    cfg = PipelineConfig(backbone_name=ARCH, layers=("blocks.1",),
                         pretrain_embed_dimension=8,
                         target_embed_dimension=8, tau=1.0,
                         supervised="unsupervised")
    vis = {}
    for tag, main in (("jax", jeval.main), ("torch", teval.main)):
        out = str(tmp_path / tag)
        d = artifact_dir(out, "mvtec_ad", ARCH, "unsupervised", cfg)
        os.makedirs(d)
        with open(os.path.join(d, "matrix_alpha_X_bottle_unsupervised"
                                  ".pickle"), "wb") as f:
            pickle.dump((alpha, x), f)
        _quiet(main, ["--path", root, "--output_dir", out, "--visualize",
                      *flags])
        vis[tag] = os.path.join(out, "mvtec_ad", "visualize",
                                f"{ARCH}_8_8_blocks.1_1.0_unsupervised")
    names = sorted(os.listdir(vis["jax"]))
    assert sorted(os.listdir(vis["torch"])) == names == [
        "bottle_broken_large.png", "bottle_contamination.png",
        "bottle_good.png"]
    for name in names:
        np.testing.assert_array_equal(
            _pixels(os.path.join(vis["torch"], name)),
            _pixels(os.path.join(vis["jax"], name)), err_msg=name)


def test_tutorial_matches(tmp_path, monkeypatch):
    import tutorial
    from tpu_ac_torch import tutorial as ttutorial

    banks = []
    mine = tscan.MemoryBank.mine_nearest_neighbors

    def keep(self, *a, **kw):
        banks.append(self.features.numpy().astype(np.float64))
        return mine(self, *a, **kw)

    monkeypatch.setattr(tscan.MemoryBank, "mine_nearest_neighbors", keep)
    want, _ = _quiet(tutorial.main, ["--out_dir", str(tmp_path / "jax")])
    got, _ = _quiet(ttutorial.main, ["--out_dir", str(tmp_path / "t"),
                                     "--device", "cpu"])
    for (split, topk), feats in zip((("train", 20), ("val", 5)), banks):
        g, w = got[split], want[split]
        assert g["accuracy"] == w["accuracy"]
        assert os.path.basename(g["path"]) == os.path.basename(w["path"])
        np.testing.assert_array_equal(np.load(g["path"]), g["indices"])
        assert g["indices"].shape == w["indices"].shape == (96, topk + 1)
        # the seeded init's features lie close together (similarities
        # near 0.999, neighbours apart by 1e-7 to 1e-5): the packages' f32
        # features may order near-ties differently, so a row is held as a
        # set where its k-th and (k+1)-th similarities are apart by more
        # than TIE, and in order where all its top k + 2 are
        sims = -np.sort(-(feats @ feats.T), axis=1)[:, :topk + 2]
        gaps = -np.diff(sims, axis=1)
        clear = gaps[:, topk] > TIE
        assert clear.mean() >= 0.5
        for gi, wi in zip(g["indices"][clear], w["indices"][clear]):
            assert set(gi) == set(wi)
        ordered = (gaps > TIE).all(axis=1)
        np.testing.assert_array_equal(g["indices"][ordered],
                                      w["indices"][ordered])
        assert (g["indices"] == w["indices"]).all(axis=1).mean() >= 0.9
