"""Self-attention visualization CLI (port of
``tpu_ac.cli.visualize_attention``; the Anomaly-Clustering fork's
dino-main/visualize_attention.py).

The fork sweeps EVERY block (visualize_attention.py:191-194,
``get_index_selfattention(img, i) for i in range(12)``) and per block
saves a subplot grid of all head attention maps + the input image + the
MVTec ground-truth mask (derived from the image path,
test -> ground_truth, .png -> _mask.png).  With ``--threshold`` it also
saves per-head binary masks keeping the top ``threshold`` fraction of the
attention mass (visualize_attention.py:200-210: sort ascending,
normalize, cumsum > 1-threshold, unsort).

As in ``tpu_ac``, all blocks' attentions come from ONE forward
(``ViT.all_selfattentions``, f32 with TF32 off) instead of re-running the
block prefix per index.  The reference overwrites the threshold-mask files
on every block iteration so only the final block's survive; this writes
exactly that final state.  ``attention_arrays`` does the array work on
the device and imports no matplotlib; ``main`` draws what it returns.

    python -m tpu_ac_torch.cli.visualize_attention --image_path img.png \
        [--arch dino_deitsmall8] [--threshold 0.6] [--image_size 224 224] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
from PIL import Image

from tpu_ac_torch.data.mvtec import (IMAGENET_MEAN, IMAGENET_STD,
                                     _resize_shorter_edge)
from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.ops.interpolate import interpolate_nearest


def _center_crop_2d(arr: np.ndarray, th: int, tw: int) -> np.ndarray:
    """transforms.CenterCrop((th, tw)) on HWC, incl. the zero-pad branch
    for crops larger than the image."""
    h, w = arr.shape[:2]
    if th > h or tw > w:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        arr = np.pad(arr, ((ph // 2, ph - ph // 2),
                           (pw // 2, pw - pw // 2), (0, 0)))
        h, w = arr.shape[:2]
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return arr[top:top + th, left:left + tw]


def cumulative_mass(cls_attn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[nh, N] CLS attention -> (share, cum), each [nh, N]: an element's
    share of its head's mass, and the summed share of the elements up to
    it in ascending order (visualize_attention.py:200-207)."""
    idx = np.argsort(cls_attn, axis=1)  # ascending, like torch.sort
    val = np.take_along_axis(cls_attn, idx, axis=1)
    val = val / val.sum(axis=1, keepdims=True)
    cumval = np.cumsum(val, axis=1)
    idx2 = np.argsort(idx, axis=1)  # inverse permutation
    return (np.take_along_axis(val, idx2, axis=1),
            np.take_along_axis(cumval, idx2, axis=1))


def threshold_masks(cls_attn: np.ndarray, threshold: float) -> np.ndarray:
    """[nh, N] CLS attention -> [nh, N] binary masks keeping the top
    ``threshold`` fraction of each head's mass
    (visualize_attention.py:200-208)."""
    return (cumulative_mass(cls_attn)[1] > (1 - threshold)).astype(
        np.float32)


def _save_overlay(image_u8: np.ndarray, mask: np.ndarray,
                  fname: str) -> None:
    """display_instances (visualize_attention.py:42-84) without the
    skimage contour dependency when it's absent: alpha-blend the mask in
    the deterministic N=1 color (hsv (0,1,1) = red) and draw contours if
    skimage is importable."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    color = (1.0, 0.0, 0.0)
    out = image_u8.astype(np.float32).copy()
    for c in range(3):
        out[:, :, c] = (out[:, :, c] * (1 - 0.5 * mask)
                        + 0.5 * mask * color[c] * 255)
    fig = plt.figure(figsize=(5, 5), frameon=False)
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.set_axis_off()
    fig.add_axes(ax)
    try:
        from skimage.measure import find_contours

        padded = np.zeros((mask.shape[0] + 2, mask.shape[1] + 2))
        padded[1:-1, 1:-1] = mask
        for verts in find_contours(padded, 0.5):
            from matplotlib.patches import Polygon

            ax.add_patch(Polygon(np.fliplr(verts) - 1, facecolor="none",
                                 edgecolor=color))
    except ImportError:
        pass
    ax.imshow(out.astype(np.uint8), aspect="auto")
    fig.savefig(fname)
    plt.close(fig)
    print(f"{fname} saved.")


def attention_arrays(model, image_path: str,
                     image_size: tuple[int, int] = (224, 224),
                     threshold: float | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """The arrays ``main`` draws, on the host as numpy:

    - ``cls_attn`` [depth, nh, N]: every block's CLS row over the patch
      tokens (all prefix tokens dropped);
    - ``maps`` [depth, nh, H, W]: those rows on the token grid,
      nearest-upsampled to the image;
    - ``th_attn_up`` [nh, H, W] or None: the final block's threshold
      masks, upsampled;
    - ``disp`` [H, W, 3]: the input min-max rescaled to [0, 1];
    - ``gt`` [h, w, 3] uint8 or None: the MVTec ground-truth mask;
    - ``image`` [3, H, W]: the normalized input the forward took.

    The forward and the upsampling run on ``device``; ``model`` (the
    port's ``ViT``) is moved there.
    """
    dev = resolve_device(device)
    patch = model.cfg.patch_size
    img = Image.open(image_path).convert("RGB")
    arr = np.asarray(_resize_shorter_edge(img, 256), np.float32) / 255.0
    arr = _center_crop_2d(arr, image_size[0], image_size[1])
    chw = ((arr - IMAGENET_MEAN) / IMAGENET_STD).transpose(2, 0, 1)
    # make the image divisible by the patch size
    h_pix = chw.shape[1] - chw.shape[1] % patch
    w_pix = chw.shape[2] - chw.shape[2] % patch
    chw = chw[:, :h_pix, :w_pix]
    w_featmap, h_featmap = h_pix // patch, w_pix // patch  # (rows, cols)
    # img.png: make_grid(normalize=True, scale_each=True) of one image
    # is a per-image min-max rescale
    lo, hi = chw.min(), chw.max()
    disp = ((chw - lo) / max(hi - lo, 1e-12)).transpose(1, 2, 0)

    # the fork overlays the MVTec ground-truth mask when it exists
    gt_path = (image_path.replace("test", "ground_truth")
               .replace(".png", "_mask.png"))
    gt = None
    if os.path.isfile(gt_path):
        g = Image.open(gt_path).convert("RGB")
        g_arr = np.asarray(_resize_shorter_edge(g, 256), np.float32)
        gt = _center_crop_2d(g_arr, image_size[0],
                             image_size[1]).astype(np.uint8)

    skip = model.cfg.num_prefix_tokens
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(chw[None])).to(dev)
        all_attn = model.to(dev).all_selfattentions(x)  # [depth,1,nh,N+,N+]
        # a copy, so that the [depth, 1, nh, N+, N+] maps are freed here
        cls_attn = all_attn[:, 0, :, 0, skip:].clone()  # [depth, nh, N]
        del all_attn
        depth, nh = cls_attn.shape[:2]
        maps = interpolate_nearest(
            cls_attn.reshape(depth, nh, w_featmap, h_featmap),
            size=(h_pix, w_pix))
        cls_np, maps = cls_attn.cpu().numpy(), maps.cpu().numpy()
        th_attn_up = None
        if threshold is not None:
            th = threshold_masks(cls_np[-1], threshold)
            th = torch.from_numpy(th.reshape(nh, w_featmap, h_featmap))
            th_attn_up = interpolate_nearest(
                th.to(dev)[None], size=(h_pix, w_pix))[0].cpu().numpy()
    return dict(cls_attn=cls_np, maps=maps, th_attn_up=th_attn_up,
                disp=disp, gt=gt, image=chw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Visualize Self-Attention maps (PyTorch)")
    p.add_argument("--arch", default="dino_deitsmall8",
                   help="backbone registry name (the reference's "
                        "vit_small/patch 8 default)")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--image_path", required=True, type=str,
                   help="Path of the image to load (no default: the "
                        "reference falls back to an HTTP fetch)")
    p.add_argument("--image_size", default=(224, 224), type=int, nargs="+",
                   help="Resize image.")
    p.add_argument("--output_dir", default="./output",
                   help="Path where to save visualizations.")
    p.add_argument("--threshold", type=float, default=None,
                   help="visualize masks keeping this fraction of the "
                        "self-attention mass")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model, cfg, family = load_backbone(args.arch,
                                       checkpoint_dir=args.checkpoint_dir)
    if family != "vit":
        raise SystemExit(f"Architecture {args.arch} non supported")
    size = tuple(args.image_size)
    if len(size) == 1:
        size = (size[0], size[0])
    a = attention_arrays(model, args.image_path, size, args.threshold, dev)
    disp, gt = np.clip(a["disp"], 0, 1), a["gt"]
    nh = a["maps"].shape[1]

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.output_dir, exist_ok=True)
    img_png = os.path.join(args.output_dir, "img.png")
    plt.imsave(img_png, disp)
    written = [img_png]
    for block_index, maps in enumerate(a["maps"]):
        cols = 3
        rows = math.ceil((nh + 2) / cols)
        fig = plt.figure(figsize=(4 * cols, 4 * rows))
        for j in range(nh):
            ax = fig.add_subplot(rows, cols, j + 1)
            ax.imshow(maps[j])
            ax.axis("off")
        ax = fig.add_subplot(rows, cols, nh + 1)
        ax.imshow(disp)
        ax.axis("off")
        if gt is not None:
            ax = fig.add_subplot(rows, cols, nh + 2)
            ax.imshow(gt)
            ax.axis("off")
        fname = os.path.join(args.output_dir,
                             f"blocks.{block_index}_attn-head.png")
        fig.savefig(fname)
        plt.close(fig)
        print(f"{fname} saved.")
        written.append(fname)

    if a["th_attn_up"] is not None:
        image_u8 = (disp * 255).astype(np.uint8)
        for j in range(nh):
            fname = os.path.join(
                args.output_dir, f"mask_th{args.threshold}_head{j}.png")
            _save_overlay(image_u8, a["th_attn_up"][j], fname)
            written.append(fname)
    return written


if __name__ == "__main__":
    main()
