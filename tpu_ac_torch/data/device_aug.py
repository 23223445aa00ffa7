"""Device-side DINO multi-crop augmentation (port of
``tpu_ac.data.device_aug``): the ``--device_aug`` path of ``cli.dino``.

The host only decodes and square-resizes each image once to a uint8 base
(``load_base_image``, or a row of the ``build_base_cache`` memmap); every
crop is made on the card from it: RandomResizedCrop boxes (torchvision's
10 tries, the center fallback), the crop's resample, flip, ColorJitter in
a random op order, grayscale, gaussian blur, solarize and normalization.

The resample is ``tpu_ac``'s ``jax.image.scale_and_translate(method=
"cubic", antialias=True)``: Keys' cubic (a = -0.5) at half-pixel centres,
the kernel widened by 1/scale where the crop shrinks, each output's
weights normalized to sum 1, outputs whose centre falls outside the image
zeroed.  Neither ``F.interpolate(mode="bicubic")`` (a = -0.75, no
translation, no widening) nor ``ops/interpolate.py`` computes it, so each
crop gets its own [out, S] weight matrices, applied as two batched
products.  The jitter's blend formulas, the HSV round trip and the
row-normalized Toeplitz blur are ``tpu_ac``'s, op for op.

A slot's crops (all first globals, all second globals, the locals) are
one batch here, where ``tpu_ac`` maps one crop at a time: the globals go
as one batch of 2B with the blur and solarize probabilities set per crop,
the locals as one batch of L*B.  The random numbers come from a
``torch.Generator`` on the card; ``tpu_ac``'s threefry streams cannot be
reproduced, so, as between ``tpu_ac``'s own two paths (PARITY.md #23),
the crops match ``tpu_ac``'s in distribution, not in bits, while each op
matches ``tpu_ac``'s on the same boxes and factors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os

import numpy as np
import torch

from tpu_ac_torch.data.mvtec import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _channel_stats,
)

_RATIO = (3.0 / 4.0, 4.0 / 3.0)  # RandomResizedCrop default aspect range


@dataclasses.dataclass(frozen=True)
class DeviceAugConfig:
    global_crops_scale: tuple[float, float] = (0.4, 1.0)
    local_crops_scale: tuple[float, float] = (0.05, 0.4)
    local_crops_number: int = 8
    global_size: int = 224
    local_size: int = 96
    base_size: int = 256  # host-side square resize the crops sample from
    blur_kernel: int = 13  # taps; covers sigma <= 2 (3 sigma + centre)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


# -- RandomResizedCrop.get_params (torchvision) ---------------------------

def _sample_boxes(gen: torch.Generator, n: int, size: int,
                  scale: tuple[float, float]):
    """[n] crop boxes (top, left, h, w) on a size x size square image:
    10 area/aspect tries, the first in-bounds one wins; the fallback, the
    aspect-clamped centre crop, is the full image on a square input."""
    area = float(size * size)
    target = area * _uniform(gen, (n, 10), scale[0], scale[1])
    log_r = (float(np.log(_RATIO[0])), float(np.log(_RATIO[1])))
    aspect = torch.exp(_uniform(gen, (n, 10), *log_r))
    cw = torch.round(torch.sqrt(target * aspect))
    ch = torch.round(torch.sqrt(target / aspect))
    valid = (cw > 0) & (ch > 0) & (cw <= size) & (ch <= size)
    first = torch.argmax(valid.to(torch.float32), dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    cw = torch.gather(cw, 1, first)[:, 0]
    ch = torch.gather(ch, 1, first)[:, 0]
    # randint(0, size - c) inclusive == floor(u * (size - c + 1))
    top = torch.floor(_uniform(gen, (n,), 0.0, 1.0) * (size - ch + 1.0))
    left = torch.floor(_uniform(gen, (n,), 0.0, 1.0) * (size - cw + 1.0))
    full = torch.full_like(cw, float(size))
    zero = torch.zeros_like(cw)
    return (torch.where(any_valid, top, zero),
            torch.where(any_valid, left, zero),
            torch.where(any_valid, ch, full),
            torch.where(any_valid, cw, full))


# -- the crop's resample: jax.image.scale_and_translate, cubic, antialias --

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5, at |offset| x (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """[n, out, in] weights of ``jax.image.scale_and_translate``'s
    ``compute_weight_mat`` (there [in, out]) for per-crop ``scale`` and
    ``translation`` [n]."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)[:, :, None]
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5)[None] * inv_scale
                - translation[:, None] * inv_scale - 0.5)  # [n, out]
    x = torch.abs(sample_f[:, :, None] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[None, None]) / kernel_scale
    w = _keys_cubic(x)
    total = torch.sum(w, dim=2, keepdim=True)
    tiny = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > tiny,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def _crop_resize(images: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
                 ch: torch.Tensor, cw: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """Crop n's box (top, left, ch, cw) of ``images[n]`` [n, 3, S, S]
    resampled to out_size^2: ``tpu_ac``'s ``_crop_resize`` (scale t/c,
    translation -top * t/c per axis), one crop a row of the batch."""
    t = float(out_size)
    s = images.shape[-1]
    wy = _resample_weights(images.shape[-2], out_size, t / ch, -top * t / ch)
    wx = _resample_weights(s, out_size, t / cw, -left * t / cw)
    rows = torch.matmul(wy[:, None], images)  # [n, 3, out, S]
    return torch.matmul(rows, wx[:, None].transpose(-1, -2))


# -- ColorJitter (torchvision blend formulas) ------------------------------

def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """[n, 3, H, W] -> [n, 1, H, W], torchvision's rgb_to_grayscale."""
    return (0.2989 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] RGB in [0, 1] -> HSV, channel axis -3."""
    r, g, b = x.unbind(-3)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(
        mx == r, (g - b) / safe,
        torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.remainder(torch.where(d == 0, torch.zeros_like(h), h / 6.0),
                        1.0)
    s = torch.where(mx == 0, torch.zeros_like(d),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-3)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-3)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-3)


def _hue(x: torch.Tensor, fh: torch.Tensor) -> torch.Tensor:
    hsv = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    h = torch.remainder(hsv[:, 0] + fh[:, None, None], 1.0)
    return _hsv_to_rgb(torch.cat([h[:, None], hsv[:, 1:]], dim=1))


def _color_jitter(x: torch.Tensor, perm: torch.Tensor, fb: torch.Tensor,
                  fc: torch.Tensor, fs: torch.Tensor,
                  fh: torch.Tensor) -> torch.Tensor:
    """Crops [n, 3, T, T] in [0, 1]; crop n's four adjustments in the
    order ``perm[n]`` (0 brightness, 1 contrast, 2 saturation, 3 hue), each
    torchvision's blend, enhanced = f * img + (1 - f) * degenerate,
    clamped.  The three blends differ only in the degenerate image (0, the
    grayscale mean, the grayscale), so each of the four steps computes
    one blend with per-crop factors and one hue shift, and keeps what the
    crop's op asks for."""
    col = (slice(None),) + (None,) * 3
    for step in range(4):
        op = perm[:, step]
        gray = _grayscale(x)
        mean = torch.mean(gray, dim=(1, 2, 3), keepdim=True)
        f = torch.where(op == 0, fb, torch.where(op == 1, fc, fs))[col]
        degenerate = torch.where(
            (op == 0)[col], torch.zeros_like(gray),
            torch.where((op == 1)[col], mean.expand_as(gray), gray))
        blend = torch.clamp(f * x + (1.0 - f) * degenerate, 0.0, 1.0)
        x = torch.where((op == 3)[col], _hue(x, fh), blend)
    return x


# -- Gaussian blur as Toeplitz products ------------------------------------

def _blur_matrix(sigma: torch.Tensor, size: int, ktaps: int) -> torch.Tensor:
    """[n, size, size] row-normalized banded matrices of gaussian taps,
    one per sigma [n]; edge rows renormalize over in-bounds taps (PIL's
    clamped-kernel edges)."""
    r = ktaps // 2
    dev = sigma.device
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    taps = torch.exp(-0.5 * (offs[None] / sigma[:, None]) ** 2)  # [n, k]
    idx = torch.arange(size, device=dev)
    d = idx[None, :] - idx[:, None]  # [out, in]
    w = taps[:, torch.clamp(d + r, 0, ktaps - 1)]  # [n, out, in]
    w = torch.where((torch.abs(d) <= r)[None], w, torch.zeros_like(w))
    return w / torch.sum(w, dim=2, keepdim=True)


def _blur(x: torch.Tensor, sigma: torch.Tensor, ktaps: int) -> torch.Tensor:
    """Separable blur of square crops [n, 3, T, T]: rows then columns."""
    m = _blur_matrix(sigma, x.shape[-1], ktaps)[:, None]
    return torch.matmul(m, torch.matmul(x, m.transpose(-1, -2)))


# -- one batch of crops -----------------------------------------------------

def _crop_batch(images: torch.Tensor, gen: torch.Generator, out_size: int,
                scale: tuple[float, float], blur_p: torch.Tensor,
                solarize_p: torch.Tensor, ktaps: int) -> torch.Tensor:
    """One crop per row of ``images`` [n, 3, S, S] f32 in [0, 1], with
    per-crop blur and solarize probabilities [n] -> normalized
    [n, 3, out, out]."""
    n, dev = images.shape[0], images.device
    top, left, ch, cw = _sample_boxes(gen, n, images.shape[-1], scale)
    crops = torch.clamp(_crop_resize(images, top, left, ch, cw, out_size),
                        0.0, 1.0)  # bicubic over/undershoot
    col = (slice(None),) + (None,) * 3

    def coin(p):
        return (_uniform(gen, (n,), 0.0, 1.0) < p)[col]

    crops = torch.where(coin(0.5), torch.flip(crops, dims=(-1,)), crops)
    # color jitter p=0.8, random op order, torchvision's factor ranges
    perm = torch.argsort(_uniform(gen, (n, 4), 0.0, 1.0), dim=1)
    fb = _uniform(gen, (n,), 0.6, 1.4)
    fc = _uniform(gen, (n,), 0.6, 1.4)
    fs = _uniform(gen, (n,), 0.8, 1.2)
    fh = _uniform(gen, (n,), -0.1, 0.1)
    crops = torch.where(coin(0.8), _color_jitter(crops, perm, fb, fc, fs, fh),
                        crops)
    crops = torch.where(coin(0.2), _grayscale(crops).expand_as(crops), crops)
    # gaussian blur, sigma ~ U(0.1, 2) (utils.GaussianBlur radii)
    sigma = _uniform(gen, (n,), 0.1, 2.0)
    crops = torch.where(coin(blur_p), _blur(crops, sigma, ktaps), crops)
    # solarize (ImageOps.solarize, threshold 128)
    inverted = torch.where(crops >= 128.0 / 255.0, 1.0 - crops, crops)
    crops = torch.where(coin(solarize_p), inverted, crops)
    mean, std = _channel_stats(tuple(float(v) for v in IMAGENET_MEAN),
                               tuple(float(v) for v in IMAGENET_STD), dev)
    return (crops - mean) / std


def device_multicrop(images_u8: torch.Tensor, gen: torch.Generator,
                     cfg: DeviceAugConfig):
    """[B, 3, S, S] uint8 base images on the card + a generator there ->
    (global_crops [2B, 3, Tg, Tg], local_crops [L*B, 3, Tl, Tl] or None),
    crop-major like ``CropBatchPrefetcher._assemble``: all first globals,
    then all second globals, the locals slot by slot.  The first global is
    always blurred, the second with p 0.1 and solarized with p 0.2, each
    local blurred with p 0.5."""
    x = images_u8.to(torch.float32) / 255.0
    b, dev = x.shape[0], x.device

    def per_slot(values):  # filled on the device: no host-to-device copy
        return torch.cat([torch.full((b,), v, device=dev) for v in values])

    g = _crop_batch(x.repeat(2, 1, 1, 1), gen, cfg.global_size,
                    cfg.global_crops_scale, per_slot([1.0, 0.1]),
                    per_slot([0.0, 0.2]), cfg.blur_kernel)
    nl = cfg.local_crops_number
    if nl == 0:
        return g, None
    l = _crop_batch(x.repeat(nl, 1, 1, 1), gen, cfg.local_size,
                    cfg.local_crops_scale, per_slot([0.5] * nl),
                    per_slot([0.0] * nl), cfg.blur_kernel)
    return g, l


def load_base_image(img, base_size: int) -> np.ndarray:
    """Host side: PIL image -> square uint8 base [3, base, base]
    (shorter-edge bilinear resize + centre crop).  A pre-decoded uint8
    array of the right shape (a ``build_base_cache`` row) passes through
    untouched."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        if (img.dtype != np.uint8
                or img.shape != (3, base_size, base_size)):
            raise ValueError(
                f"pre-decoded base image must be uint8 [3, {base_size}, "
                f"{base_size}], got {img.dtype} {img.shape}")
        return img
    w, h = img.size
    s = base_size / min(w, h)
    img = img.resize((max(base_size, int(round(w * s))),
                      max(base_size, int(round(h * s)))), Image.BILINEAR)
    w, h = img.size
    left = (w - base_size) // 2
    top = (h - base_size) // 2
    img = img.crop((left, top, left + base_size, top + base_size))
    return np.asarray(img.convert("RGB"), np.uint8).transpose(2, 0, 1)


def build_base_cache(dataset, base_size: int, cache_dir: str) -> np.ndarray:
    """Decode-once, memory-mapped uint8 base-image cache for the
    ``--device_aug`` path: ``load_base_image`` of the whole dataset into
    an ``open_memmap`` .npy [N, 3, base, base], keyed by a digest of the
    ordered file list and the base size, and reused across runs.  The
    per-epoch host work then drops to one memmap read a batch."""
    paths = [p for p, _ in dataset.samples]
    digest = hashlib.sha1("\n".join(paths).encode()).hexdigest()[:12]
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(
        cache_dir, f"dino_base_{len(paths)}_{base_size}_{digest}.npy")
    if not os.path.exists(cache_path):
        # per-process temp name: concurrent builders must not truncate
        # each other's live memmap; every builder writes the same bytes,
        # so the atomic replace is last-writer-wins and consistent
        tmp_path = f"{cache_path}.tmp.{os.getpid()}"
        arr = np.lib.format.open_memmap(
            tmp_path, mode="w+", dtype=np.uint8,
            shape=(len(paths), 3, base_size, base_size))
        try:
            for i in range(len(paths)):
                img, _ = dataset[i]
                arr[i] = load_base_image(img, base_size)
            arr.flush()
        except BaseException:
            del arr
            # a failing unlink must not replace the error that got here
            with contextlib.suppress(OSError):
                os.unlink(tmp_path)
            raise
        del arr
        os.replace(tmp_path, cache_path)
    return np.load(cache_path, mmap_mode="r")
