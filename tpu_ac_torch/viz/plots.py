"""Plotting / visualization utilities (port of ``tpu_ac.viz.plots``):
matplotlib and PIL on the host; ``attention_maps`` runs the ViT on a
device.  matplotlib is imported inside the functions that draw, so the
module imports where it is not installed.

- ``read_results_csv`` / ``draw_metrics``: tau-sweep result curves
  (Anomaly-Clustering/utils/draw.py:7-116).
- ``alpha_heatmap`` / ``visualize_alpha_on_image``: per-image alpha weight
  maps, nearest-neighbor upsampled next to the source image
  (utils/draw_alpha.py:74-134, examples/test.py:71-105,158-174).
- ``feature_map_grid`` / ``feature_map_visualize``: per-patch mean-embedding
  intensity maps, saved once per anomaly label (examples/main.py:72-181).
- ``plot_segmentation_images``: image/mask/heatmap triptychs
  (models/patchcore/utils.py:18-77).
- ``attention_maps``: per-head CLS attention of the last block
  (dino-main/visualize_attention.py:38-247), on the device the caller
  names.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np
import torch

from tpu_ac_torch.data.mvtec import IMAGENET_MEAN, IMAGENET_STD
from tpu_ac_torch.device import resolve_device


def read_results_csv(path: str, encoding: str = "utf-8") -> dict:
    """Parse a tau-sweep CSV written by tpu_ac.cli.evaluate (or the
    reference's GBK CSVs with encoding='gbk') into
    {tau: {category: (NMI, ARI, F1)}}."""
    out: dict[float, dict[str, tuple]] = {}
    tau = None
    with open(path, encoding=encoding, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            if row[0].startswith("TAU="):
                tau = float(row[0].split("=", 1)[1])
                out[tau] = {}
            elif tau is not None and len(row) == 4 and row[1] != "NMI" \
                    and row[0] != "---":
                try:
                    out[tau][row[0]] = tuple(float(v) for v in row[1:])
                except ValueError:
                    continue
    return out


def draw_metrics(results: dict, categories: list[str], metric: str = "NMI",
                 save_path: str | None = None):
    """Metric-vs-tau curves per category (utils/draw.py:60-116)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idx = {"NMI": 0, "ARI": 1, "F1": 2}[metric]
    taus = sorted(results)
    fig, ax = plt.subplots(figsize=(8, 5))
    for cat in categories:
        ys = [results[t][cat][idx] for t in taus if cat in results[t]]
        xs = [t for t in taus if cat in results[t]]
        ax.plot(xs, ys, marker="o", label=cat)
    ax.set_xlabel("tau")
    ax.set_ylabel(metric)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def _denormalize(image_chw: np.ndarray) -> np.ndarray:
    img = image_chw.transpose(1, 2, 0) * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(img, 0, 1)


def alpha_heatmap(alpha_row: np.ndarray, upsample: int = 8) -> np.ndarray:
    """[P] alpha weights -> [G*u, G*u] heat map, nearest-neighbor upsampled
    and max-normalized (examples/test.py:160-168, draw_alpha.py:96-110)."""
    g = int(math.isqrt(len(alpha_row)))
    grid = np.asarray(alpha_row, np.float32).reshape(g, g)
    grid = grid / max(grid.max(), 1e-12)
    return np.kron(grid, np.ones((upsample, upsample), np.float32))


def visualize_alpha_on_image(image_chw: np.ndarray, alpha_row: np.ndarray,
                             save_path: str | None = None):
    """Side-by-side source image + alpha heat map (test.py:71-105)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    heat = alpha_heatmap(alpha_row)
    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(_denormalize(image_chw))
    axes[0].set_title("image")
    axes[1].imshow(heat, cmap="viridis")
    axes[1].set_title("alpha")
    for ax in axes:
        ax.axis("off")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_sweep_alpha(alpha: np.ndarray, items, out_dir: str,
                          resize: int = 256, imagesize: int = 224) -> list[str]:
    """Per-anomaly-type alpha heatmap export during the stage-2 sweep
    (examples/test.py:158-174 + visualize test.py:71-105).

    For the FIRST image of each anomaly type: a figure with the source
    image, the ground-truth mask (anomalous types), and the max-normalized
    8x nearest-upsampled alpha heat map, saved as
    ``<out_dir>/<classname>_<anomaly>.png``.  Returns the saved paths.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    def load(path, gray=False):
        img = Image.open(path)
        img = img.convert("L" if gray else "RGB")
        img = img.resize((resize, resize), Image.BILINEAR)
        left = (resize - imagesize) // 2
        return np.asarray(
            img.crop((left, left, left + imagesize, left + imagesize)))

    os.makedirs(out_dir, exist_ok=True)
    saved = []
    label_current = "start"  # test.py:159 — first image of each type only
    for i, it in enumerate(items):
        if it.anomaly == label_current:
            continue
        label_current = it.anomaly
        heat = alpha_heatmap(np.asarray(alpha[i]).reshape(-1))
        fig = plt.figure(figsize=(12, 4))
        ax1 = fig.add_subplot(131)
        ax1.imshow(load(it.image_path))
        ax1.axis("off")
        if it.mask_path:
            ax2 = fig.add_subplot(132)
            ax2.imshow(load(it.mask_path, gray=True), cmap="gray")
            ax2.axis("off")
        ax3 = fig.add_subplot(133)
        ax3.imshow(heat, cmap="viridis")
        ax3.axis("off")
        fname = os.path.join(out_dir, f"{it.classname}_{it.anomaly}.png")
        fig.savefig(fname, dpi=100, bbox_inches="tight")
        plt.close(fig)
        saved.append(fname)
    return saved


def feature_map_grid(z_i: np.ndarray) -> np.ndarray:
    """[P, D] patch embeddings -> min-max-normalized [G, G] intensity map
    (examples/main.py:165-175: per-patch mean over the embedding dim,
    normalized to [0, 1], reshaped onto the square grid)."""
    z = np.asarray(z_i, np.float32).mean(axis=1)
    lo, hi = z.min(), z.max()
    z = (z - lo) / max(hi - lo, 1e-12)
    g = int(math.isqrt(len(z)))
    return z.reshape(g, g)


def feature_map_visualize(Z: np.ndarray, anomaly_labels: list[str],
                          out_dir: str, tag: str,
                          images_chw: np.ndarray | None = None) -> list[str]:
    """feature_map_visualize (examples/main.py:72-181): save one per-patch
    mean-embedding intensity map per *first occurrence* of each anomaly
    label (the reference's ``label_current`` walk).  Returns saved paths.

    Z: [N, P, D] patch embeddings; images_chw: optional normalized source
    images rendered alongside the map (the reference shows the image + gt
    mask + map; the mask panel needs the dataset tree and lives in
    ``plot_segmentation_images``).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    saved: list[str] = []
    label_current = None
    for i, label in enumerate(anomaly_labels):
        if label == label_current:
            continue
        label_current = label
        grid = feature_map_grid(Z[i])
        cols = 2 if images_chw is not None else 1
        fig, axes = plt.subplots(1, cols, figsize=(4 * cols, 4),
                                 squeeze=False)
        if images_chw is not None:
            axes[0][0].imshow(_denormalize(images_chw[i]))
            axes[0][0].set_title("image")
        axes[0][-1].imshow(grid, cmap="gray")
        axes[0][-1].set_title(f"mean embedding ({label})")
        for ax in axes[0]:
            ax.axis("off")
        path = os.path.join(out_dir, f"{tag}_{label}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        saved.append(path)
    return saved


def plot_segmentation_images(save_dir: str, image_paths: list[str],
                             segmentations: np.ndarray,
                             anomaly_scores=None, mask_paths=None,
                             image_transform=lambda x: x) -> None:
    """Image / ground-truth / predicted-heatmap rows saved per image
    (models/patchcore/utils.py:18-77)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    for i, (path, seg) in enumerate(zip(image_paths, segmentations)):
        img = image_transform(np.asarray(Image.open(path).convert("RGB")))
        cols = 3 if mask_paths else 2
        fig, axes = plt.subplots(1, cols, figsize=(4 * cols, 4))
        axes[0].imshow(img)
        axes[0].set_title("image")
        if mask_paths:
            mask = np.asarray(Image.open(mask_paths[i])) if mask_paths[i] \
                else np.zeros(seg.shape)
            axes[1].imshow(mask, cmap="gray")
            axes[1].set_title("ground truth")
        axes[-1].imshow(seg, cmap="jet")
        title = "prediction"
        if anomaly_scores is not None:
            title += f" (score {anomaly_scores[i]:.3f})"
        axes[-1].set_title(title)
        for ax in axes:
            ax.axis("off")
        fig.savefig(os.path.join(save_dir, f"segmentation_{i:04d}.png"),
                    dpi=100, bbox_inches="tight")
        plt.close(fig)


def attention_maps(model, image_chw: np.ndarray,
                   save_dir: str | None = None,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Per-head CLS attention of the final block, reshaped to the patch
    grid and nearest-upsampled to image size, [nh, H, W] on the host
    (visualize_attention.py:38-247).  ``model``: the port's ``ViT``, which
    is moved to ``device``; the forward runs in f32 with TF32 off."""
    from tpu_ac_torch.ops.interpolate import interpolate_nearest

    dev = resolve_device(device)
    model = model.to(dev)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(
            image_chw[None], np.float32)).to(dev)
        attn = model.last_selfattention(x)  # [1, nh, N+p, N+p]
        nh = attn.shape[1]
        # drop ALL prefix tokens (DeiT-distilled carries CLS + dist), like
        # the embed path (features/embedding.py)
        cls_attn = attn[0, :, 0, model.cfg.num_prefix_tokens:]  # [nh, N]
        # the token grid of the image, rows x columns (the reference's
        # w_featmap x h_featmap); tpu_ac takes a square isqrt(N) grid,
        # which a frame that is not square cannot reshape to
        h, w = image_chw.shape[1:]
        ps = model.cfg.patch_size
        maps = interpolate_nearest(
            cls_attn.reshape(1, nh, h // ps, w // ps),
            size=(h, w))[0].cpu().numpy()
    if save_dir:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(save_dir, exist_ok=True)
        for h_i in range(nh):
            plt.imsave(os.path.join(save_dir, f"attn-head{h_i}.png"),
                       maps[h_i], cmap="inferno")
    return maps


def visualize_indices(images_u8: "np.ndarray", indices,
                      save_path: str | None = None, cols: int = 8):
    """Image grid of selected dataset indices (cluster members or
    prototypes — Unsupervised-Classification-master/eval.py:131-145)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    indices = [int(i) for i in indices if int(i) >= 0]
    rows = max(1, (len(indices) + cols - 1) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(1.6 * cols, 1.6 * rows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes:
        ax.axis("off")
    for ax, idx in zip(axes, indices):
        ax.imshow(images_u8[idx])
        ax.set_title(str(idx), fontsize=6)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig
