"""Attention-video generation (port of ``tpu_ac.viz.video``;
dino-main/video_generation.py:40-296).

The reference extracts per-frame last-block CLS attention maps and stitches
them into a video with ffmpeg.  Here each frame's maps come from
``attention_maps`` on the device the caller names; assembly is
``tpu_ac``'s chain, which picks a file format, not a device: cv2's
VideoWriter for .mp4, then ffmpeg when present, else PIL's animated-GIF
writer, which needs no external binary.  cv2 is imported inside the
functions that use it.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import torch
from PIL import Image

from tpu_ac_torch.data.mvtec import IMAGENET_MEAN, IMAGENET_STD


def render_attention_frames(model, frames_chw: np.ndarray,
                            head: int | str = "mean",
                            device: str | torch.device = "cuda"
                            ) -> list[np.ndarray]:
    """Per-frame attention heat maps: [T, 3, H, W] -> list of [H, W]."""
    from tpu_ac_torch.viz.plots import attention_maps

    out = []
    for frame in frames_chw:
        maps = attention_maps(model, frame, device=device)
        m = maps.mean(axis=0) if head == "mean" else maps[int(head)]
        out.append(m)
    return out


def _colorize(m: np.ndarray) -> np.ndarray:
    """Map [H, W] scores to an RGB inferno-like gradient without pyplot."""
    m = m - m.min()
    m = m / max(m.max(), 1e-12)
    r = np.clip(3 * m, 0, 1)
    g = np.clip(3 * m - 1, 0, 1)
    b = np.clip(3 * m - 2, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def write_video(frames: list[np.ndarray], out_path: str, fps: float = 10
                ) -> str:
    """Assemble heat-map frames into a video.

    .mp4 output uses cv2.VideoWriter (the reference's assembler,
    video_generation.py:119-148) with ffmpeg as a secondary option;
    otherwise an animated GIF via PIL (no external binary needed).
    """
    rgb = [Image.fromarray(_colorize(f)) for f in frames]
    if out_path.endswith(".mp4"):
        try:
            import cv2

            h, w = np.asarray(rgb[0]).shape[:2]
            writer = cv2.VideoWriter(
                out_path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps),
                (w, h))
            if writer.isOpened():
                for im in rgb:
                    writer.write(cv2.cvtColor(np.asarray(im),
                                              cv2.COLOR_RGB2BGR))
                writer.release()
                return out_path
            # encoder unavailable: release the failed writer and remove
            # the stray empty file it may have claimed, so the fallback
            # output is the only artifact left behind
            writer.release()
            if os.path.exists(out_path) and os.path.getsize(out_path) == 0:
                os.remove(out_path)
        except ImportError:
            pass
        if shutil.which("ffmpeg"):
            tmpdir = out_path + ".frames"
            os.makedirs(tmpdir, exist_ok=True)
            for i, im in enumerate(rgb):
                im.save(os.path.join(tmpdir, f"{i:06d}.png"))
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", str(fps), "-i",
                 os.path.join(tmpdir, "%06d.png"), "-pix_fmt", "yuv420p",
                 out_path], check=True, capture_output=True)
            shutil.rmtree(tmpdir)
            return out_path
    gif_path = out_path if out_path.endswith(".gif") else out_path + ".gif"
    rgb[0].save(gif_path, save_all=True, append_images=rgb[1:],
                duration=int(1000 / fps), loop=0)
    return gif_path


def extract_frames_from_video(video_path: str,
                              out_dir: str | None = None
                              ) -> tuple[list[np.ndarray], float]:
    """Decode a video file into RGB frames + source fps
    (VideoGenerator._extract_frames_from_video, video_generation.py:104-117).

    Returns ([H, W, 3] uint8 frames, fps).  With ``out_dir`` the frames are
    also written as ``frame-%04d.jpg`` like the reference.
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 10.0
    frames: list[np.ndarray] = []
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    ok, image = cap.read()
    count = 0
    while ok:
        if out_dir is not None:
            cv2.imwrite(os.path.join(out_dir, f"frame-{count:04}.jpg"),
                        image)
        frames.append(cv2.cvtColor(image, cv2.COLOR_BGR2RGB))
        ok, image = cap.read()
        count += 1
    cap.release()
    return frames, float(fps)


def preprocess_frames(frames_hwc: list[np.ndarray], patch_size: int,
                      resize: int | None = None) -> np.ndarray:
    """uint8 RGB frames -> [T, 3, H', W'] normalized, cropped to a patch
    multiple (video_generation.py:160-185: optional shorter-side resize,
    ImageNet normalize, crop H/W down to patch_size multiples)."""
    out = []
    for f in frames_hwc:
        img = Image.fromarray(f)
        if resize is not None:
            w, h = img.size
            if w < h:
                nw, nh = resize, int(round(h * resize / w))
            else:
                nw, nh = int(round(w * resize / h)), resize
            img = img.resize((nw, nh), Image.BILINEAR)
        x = np.asarray(img, np.float32) / 255.0
        x = (x - IMAGENET_MEAN) / IMAGENET_STD
        x = x.transpose(2, 0, 1)
        h2 = x.shape[1] - x.shape[1] % patch_size
        w2 = x.shape[2] - x.shape[2] % patch_size
        out.append(x[:, :h2, :w2])
    return np.stack(out)


def generate_attention_video_from_path(model, input_path: str,
                                       out_path: str,
                                       resize: int | None = None,
                                       fps: float | None = None,
                                       head: int | str = "mean",
                                       device: str | torch.device = "cuda"
                                       ) -> str:
    """VideoGenerator.run equivalent for the non-video-only path
    (video_generation.py:48-101): ``input_path`` is either a VIDEO FILE
    (frames extracted at the source fps) or a DIRECTORY of already
    extracted frames; per-frame attention maps are rendered and assembled
    into a video at ``out_path``.  ``model``: the port's ``ViT``."""
    if os.path.isfile(input_path):
        raw, src_fps = extract_frames_from_video(input_path)
        fps = fps or src_fps
    elif os.path.isdir(input_path):
        names = sorted(n for n in os.listdir(input_path)
                       if n.lower().endswith((".jpg", ".jpeg", ".png")))
        if not names:
            raise FileNotFoundError(f"no frames in {input_path}")
        raw = [np.asarray(
            Image.open(os.path.join(input_path, n)).convert("RGB"))
            for n in names]
        fps = fps or 10.0
    else:
        raise FileNotFoundError(
            f"Provided input path {input_path} doesn't exist.")
    frames = preprocess_frames(raw, model.cfg.patch_size, resize)
    return generate_attention_video(model, frames, out_path, fps=fps,
                                    head=head, device=device)


def generate_attention_video(model, frames_chw: np.ndarray, out_path: str,
                             fps: float = 10, head: int | str = "mean",
                             device: str | torch.device = "cuda") -> str:
    """End-to-end VideoGenerator equivalent: frames -> attention video."""
    heat = render_attention_frames(model, frames_chw, head, device)
    return write_video(heat, out_path, fps)
