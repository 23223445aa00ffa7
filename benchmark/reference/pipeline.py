"""One category through the plain reference: decode its PNGs, embed them
with the config's reference backbone in blocks of images, and compute
alpha and X.  f32 with TF32 off throughout; ``q`` (``fp8.exact`` or
``fp8.fp8``) is applied to the operands of every product, which makes the
same code the precision control."""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from benchmark.reference import alpha as ref_alpha
from benchmark.reference.embedding import embed_tail

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_image(path: str, resize: int, imagesize: int) -> np.ndarray:
    """torchvision's Resize(resize) (shorter edge, bilinear) and
    CenterCrop(imagesize) of an RGB file -> uint8 [3, H, W]."""
    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w <= h:
        size = (resize, max(1, round(h * resize / w)))
    else:
        size = (max(1, round(w * resize / h)), resize)
    arr = np.asarray(img.resize(size, Image.BILINEAR), np.uint8)
    top = int(round((arr.shape[0] - imagesize) / 2.0))
    left = int(round((arr.shape[1] - imagesize) / 2.0))
    return arr[top:top + imagesize, left:left + imagesize].transpose(2, 0, 1)


def split_files(root: str, category: str, split: str) -> list[str]:
    """The split's images in MVTec's walk order: anomaly folders sorted,
    files sorted within each."""
    base = os.path.join(root, category, split)
    return [os.path.join(base, a, f) for a in sorted(os.listdir(base))
            for f in sorted(os.listdir(os.path.join(base, a)))]


def load_split(root: str, category: str, split: str, resize: int,
               imagesize: int) -> np.ndarray:
    files = split_files(root, category, split)
    with ThreadPoolExecutor(8) as pool:
        return np.stack(list(pool.map(
            lambda f: load_image(f, resize, imagesize), files)))


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def embed(images: np.ndarray, weights: dict, config: dict, backbone, q,
          device, block: int = 8) -> torch.Tensor:
    """uint8 [N, 3, H, W] -> Z [N, P, D] f32 on ``device``."""
    mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]
    out = []
    for s in range(0, len(images), block):
        x = torch.from_numpy(images[s:s + block]).to(device)
        x = (x.to(torch.float32) / 255.0 - mean) / std
        out.append(embed_tail(backbone.features(x, weights, config, q),
                              config, q))
    return torch.cat(out)


def category(root: str, name: str, mix, config: dict, w32: dict,
             backbone, device, q) -> tuple[np.ndarray, np.ndarray]:
    """(alpha [N, P], X [N, D]) f32 numpy of one category; ``w32``: the
    weights as f32 tensors on ``device``."""
    with no_tf32(), torch.inference_mode():
        z = embed(load_split(root, name, "test", mix.resize, mix.imagesize),
                  w32, config, backbone, q, device)
        if mix.mode == "supervised":
            zt = embed(load_split(root, name, "train", mix.resize,
                                  mix.imagesize), w32, config, backbone, q,
                       device)
            w = ref_alpha.weights_supervised(z, zt, q)
        else:
            w = ref_alpha.weights_unsupervised(z, q)
        alpha, x = ref_alpha.alpha_x(z, w, config["tau"])
    return alpha.cpu().numpy(), x.cpu().numpy()
