"""Attention-video generation CLI (port of ``tpu_ac.cli.video_generation``;
dino-main/video_generation.py).

Input is a video FILE (frames extracted via cv2 at the source fps, like
VideoGenerator._extract_frames_from_video) or a DIRECTORY of frames;
output is a video of per-frame last-block CLS attention maps, computed on
``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m tpu_ac_torch.cli.video_generation --input_path clip.mp4 \
        --output_path out/ [--arch dino_deitsmall8] [--resize 512]
"""

from __future__ import annotations

import argparse
import os

from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.viz.video import generate_attention_video_from_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Generation of attention video (PyTorch)")
    p.add_argument("--input_path", required=True,
                   help="video file or directory of extracted frames")
    p.add_argument("--output_path", default="./",
                   help="output directory (video.<format> is written there)")
    p.add_argument("--arch", default="dino_deitsmall8",
                   help="backbone registry name")
    p.add_argument("--resize", default=None, type=int,
                   help="shorter-side resize before inference")
    p.add_argument("--fps", default=None, type=float,
                   help="output fps (defaults to the source video's)")
    p.add_argument("--video_format", default="mp4", choices=["mp4", "gif"])
    p.add_argument("--head", default="mean",
                   help="'mean' or an attention-head index")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model, _cfg, family = load_backbone(args.arch,
                                        checkpoint_dir=args.checkpoint_dir)
    if family != "vit":
        raise SystemExit(f"Architecture {args.arch} non supported")
    os.makedirs(args.output_path, exist_ok=True)
    out = os.path.join(args.output_path, f"video.{args.video_format}")
    head = args.head if args.head == "mean" else int(args.head)
    path = generate_attention_video_from_path(
        model, args.input_path, out, resize=args.resize, fps=args.fps,
        head=head, device=dev)
    print(f"Done: {path}")
    return path


if __name__ == "__main__":
    main()
