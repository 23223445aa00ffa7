"""DAVIS-2017 video object segmentation CLI (port of
``tpu_ac.cli.eval_video_segmentation``; dino-main/
eval_video_segmentation.py rebuilt).

Protocol (eval_video_segmentation.py:252-295): walk
``<data_path>/ImageSets/2017/val.txt``; per video read the frames from
``JPEGImages/480p/<video>`` and the first frame's indexed-PNG annotation
from ``Annotations/480p/<video>``, propagate the mask frame by frame
through DINO patch features (first frame + the ``n_last_frames`` most
recent predictions as context), and write per-frame indexed PNGs.

As in ``tpu_ac``: the frames are embedded in batches of ``--bs`` (the
reference runs one frame at a time), in f32 with TF32 off (``tpu_ac``'s
``vit_intermediate_layers`` default, ``Precision.HIGHEST``); the
propagation runs on the device (``train/video_seg.propagate_labels``);
the DAVIS palette is the PASCAL-VOC colormap generated bitwise (the
reference fetches it over HTTP); PNGs are written through PIL.

    python -m tpu_ac_torch.cli.eval_video_segmentation \
        --data_path /path/to/davis --output_dir out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings

import numpy as np
import torch
from PIL import Image

from tpu_ac_torch.data.prefetch import to_device
from tpu_ac_torch.device import precision_scope, resolve_device
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.ops.interpolate import interpolate_bilinear
from tpu_ac_torch.train.video_seg import norm_mask, propagate_video, \
    to_one_hot

# the reference's color_normalize defaults (eval_video_segmentation.py:244):
# std[0] is 0.228 — NOT torchvision's usual 0.229 — reproduced verbatim
# (PARITY #19)
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.228, 0.224, 0.225], np.float32)


def davis_palette() -> np.ndarray:
    """[256, 3] uint8 PASCAL-VOC/DAVIS palette (bitwise colormap; equals
    the UVC palette.txt the reference fetches over HTTP)."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        lab, j = i, 0
        while lab:
            for c in range(3):
                pal[i, c] |= ((lab >> c) & 1) << (7 - j)
            lab >>= 3
            j += 1
    return pal


def imwrite_indexed(filename: str, array: np.ndarray,
                    palette: np.ndarray) -> None:
    """Save a [H, W] uint8 label map as an indexed PNG
    (eval_video_segmentation.py:167-175)."""
    if array.ndim != 2:
        raise ValueError("Saving indexed PNGs requires 2D array.")
    im = Image.fromarray(array.astype(np.uint8))
    im.putpalette(palette.ravel().tolist())
    im.save(filename, format="PNG")


def _scaled_hw(h: int, w: int, scale_size: list[int]) -> tuple[int, int]:
    """read_frame's resize rule (eval_video_segmentation.py:199-215):
    short side pinned to scale_size[0], long side floored to a multiple
    of 64."""
    if len(scale_size) == 1:
        s = scale_size[0]
        if h > w:
            tw = s
            th = int(((s * h) / w) // 64 * 64)
        else:
            th = s
            tw = int(((s * w) / h) // 64 * 64)
    else:
        th, tw = scale_size
    return th, tw


def read_frame(path: str, scale_size: list[int]
               ) -> tuple[np.ndarray, int, int]:
    """One frame -> normalized [3, th, tw] float32 + original size."""
    img = Image.open(path).convert("RGB")
    ori_w, ori_h = img.size
    th, tw = _scaled_hw(ori_h, ori_w, scale_size)
    arr = np.asarray(img.resize((tw, th), Image.BILINEAR), np.float32) / 255.0
    arr = (arr - _MEAN) / _STD
    return arr.transpose(2, 0, 1), ori_h, ori_w


def read_seg(path: str, patch_size: int, scale_size: list[int]
             ) -> tuple[np.ndarray, np.ndarray]:
    """First-frame annotation -> ([C, h, w] one-hot at the patch grid,
    original-resolution label map).

    Mirrors read_seg (eval_video_segmentation.py:226-241) including its
    quirk (PARITY #19): with a 2-element scale_size the reference reads it
    as (width, height) here but (height, width) in read_frame — only the
    1-element default path is self-consistent, and only it is ever used
    by the reference's __main__.
    """
    seg = Image.open(path)
    _w, _h = seg.size
    if len(scale_size) == 1:
        s = scale_size[0]
        if _w > _h:
            _th = s
            _tw = int(((s * _w) / _h) // 64 * 64)
        else:
            _tw = s
            _th = int(((s * _h) / _w) // 64 * 64)
    else:
        _th, _tw = scale_size[1], scale_size[0]
    small = seg.resize((_tw // patch_size, _th // patch_size),
                       Image.NEAREST)
    labels = np.asarray(small, np.int64)
    return to_one_hot(labels), np.asarray(seg)


def extract_frame_features(model: torch.nn.Module, frames: list[np.ndarray],
                           batch_size: int, device: torch.device
                           ) -> list[torch.Tensor]:
    """Last-block final-norm'd patch features per frame, [h*w, D] each on
    ``device``, in batches of ``batch_size`` (f32, TF32 off)."""
    upload = to_device(device)
    skip = model.cfg.num_prefix_tokens
    feats: list[torch.Tensor] = []
    with precision_scope("highest"):
        for start in range(0, len(frames), batch_size):
            batch = upload(np.stack(frames[start:start + batch_size]))
            out = model.intermediate_layers(batch, 1)[0]
            feats.extend(out[:, skip:, :])
    return feats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Evaluation with video object segmentation on DAVIS 2017 "
        "(PyTorch port)")
    p.add_argument("--arch", default="dino_deitsmall16",
                   help="backbone registry name (the reference's "
                        "vit_small/patch 16 default)")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--output_dir", default=".",
                   help="Path where to save segmentations")
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--n_last_frames", type=int, default=7,
                   help="number of preceeding frames")
    p.add_argument("--size_mask_neighborhood", default=12, type=int,
                   help="restrict sources to a spatial neighborhood of "
                        "the query")
    p.add_argument("--topk", type=int, default=5,
                   help="accumulate label from top k neighbors")
    p.add_argument("--bs", type=int, default=6,
                   help="feature-extraction batch size")
    p.add_argument("--scale_size", type=int, nargs="+", default=[480],
                   help="frame resize (1 value: short side, long side "
                        "floored to 64; 2 values: exact h w — HAZARD: "
                        "read_seg interprets two values as (w, h), the "
                        "reference's internal quirk (PARITY #19), so two "
                        "UNEQUAL values transpose the seg grid vs the "
                        "feature grid and produce garbage propagation)")
    p.add_argument("--video_list", default=None,
                   help="override ImageSets/2017/val.txt")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    if len(args.scale_size) == 2 and args.scale_size[0] != args.scale_size[1]:
        warnings.warn(
            "--scale_size with two UNEQUAL values: read_frame treats them "
            "as (h, w) but read_seg as (w, h) — the reference's internal "
            "quirk (PARITY #19) — so the seg grid is transposed vs the "
            "feature grid and propagation will produce garbage. Use one "
            "value (short side) or two equal values.", stacklevel=1)
    dev = resolve_device(args.device)
    model, cfg, family = load_backbone(args.arch,
                                       checkpoint_dir=args.checkpoint_dir)
    if family != "vit":
        raise SystemExit(f"Architecture {args.arch} non supported")
    model = model.to(dev)
    patch = cfg.patch_size
    palette = davis_palette()

    list_path = args.video_list or os.path.join(
        args.data_path, "ImageSets", "2017", "val.txt")
    with open(list_path) as f:
        video_names = [ln.strip() for ln in f if ln.strip()]

    written: list[str] = []
    for vi, video_name in enumerate(video_names):
        print(f"[{vi}/{len(video_names)}] Begin to segmentate video "
              f"{video_name}.")
        video_dir = os.path.join(args.data_path, "JPEGImages", "480p",
                                 video_name)
        frame_list = sorted(glob.glob(os.path.join(video_dir, "*.jpg")))
        if not frame_list:
            raise SystemExit(f"no frames under {video_dir}")
        seg_path = (frame_list[0]
                    .replace("JPEGImages", "Annotations")
                    .replace("jpg", "png"))
        first_seg, seg_ori = read_seg(seg_path, patch, args.scale_size)

        out_dir = os.path.join(args.output_dir, video_name)
        os.makedirs(out_dir, exist_ok=True)
        out0 = os.path.join(out_dir, "00000.png")
        imwrite_indexed(out0, seg_ori, palette)
        written.append(out0)

        frames, ori_h, ori_w = [], None, None
        for fp in frame_list:
            fr, ori_h, ori_w = read_frame(fp, args.scale_size)
            frames.append(fr)
        th, tw = frames[0].shape[1:]
        grid = (th // patch, tw // patch)
        feats = extract_frame_features(model, frames, args.bs, dev)

        segs = propagate_video(
            feats, first_seg, grid, n_last_frames=args.n_last_frames,
            topk=args.topk,
            size_mask_neighborhood=args.size_mask_neighborhood,
            normalize=False)
        for fp, seg in zip(frame_list[1:], segs[1:]):
            # upsample x patch FIRST, then norm_mask + argmax — the
            # reference's order (eval_video_segmentation.py:76-80)
            up = interpolate_bilinear(
                torch.from_numpy(seg)[None],
                size=(grid[0] * patch, grid[1] * patch),
                scale_factor=(float(patch), float(patch)))[0].numpy()
            lab = np.argmax(norm_mask(up), axis=0).astype(np.uint8)
            lab = np.asarray(
                Image.fromarray(lab).resize((ori_w, ori_h), Image.NEAREST))
            out_p = os.path.join(
                out_dir, os.path.basename(fp).replace(".jpg", ".png"))
            imwrite_indexed(out_p, lab, palette)
            written.append(out_p)
    return written


if __name__ == "__main__":
    main()
