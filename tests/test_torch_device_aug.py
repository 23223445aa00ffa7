"""The port's device-side multi-crop (tpu_ac_torch.data.device_aug)
against tpu_ac's.  The random streams differ (a torch.Generator against
threefry), so each op is held to tpu_ac's on the same boxes and factors:
the crop's resample against jax.image.scale_and_translate to 1e-5 (f32,
other summation orders), the jitter, HSV, grayscale and blur to 1e-5;
the boxes by their statistics; the whole program by shapes, order,
determinism per seed and range; the base cache by its bytes."""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ac.data import device_aug as jdev
from tpu_ac_torch.data import device_aug as tdev
from tpu_ac_torch.data.imagefolder import ImageFolder
from tpu_ac_torch.data.mvtec import IMAGENET_MEAN, IMAGENET_STD

TOL = 1e-5


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("out_size", [16, 48])
def test_crop_resize_matches_scale_and_translate(rng, out_size):
    """Boxes that shrink (antialiased: the kernel widened) and boxes that
    grow, some touching the borders, on a 40 px image."""
    n, s = 6, 40
    x = rng.uniform(0, 1, (n, 3, s, s)).astype(np.float32)
    top = np.array([0, 3, 10, 0, 25, 1], np.float32)
    left = np.array([0, 7, 2, 30, 0, 1], np.float32)
    ch = np.array([40, 20, 9, 10, 15, 37], np.float32)
    cw = np.array([40, 31, 12, 10, 11, 39], np.float32)
    want = np.asarray(jax.vmap(jdev._crop_resize, in_axes=(0,) * 5 + (None,))(
        jnp.asarray(x), jnp.asarray(top), jnp.asarray(left), jnp.asarray(ch),
        jnp.asarray(cw), out_size))
    got = tdev._crop_resize(*(torch.from_numpy(a) for a in
                              (x, top, left, ch, cw)), out_size).numpy()
    assert got.shape == (n, 3, out_size, out_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_resample_weights_differ_from_torch_bicubic(rng):
    """The trap: F.interpolate's bicubic (a = -0.75, no widening) is not
    jax's antialiased Keys cubic, which the port computes."""
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3, 40, 40)).astype(
        np.float32))
    ours = tdev._crop_resize(x, *(torch.tensor([v]) for v in
                                  (0.0, 0.0, 40.0, 40.0)), 16)
    theirs = torch.nn.functional.interpolate(x, size=(16, 16),
                                             mode="bicubic")
    assert (ours - theirs).abs().max() > 1e-2


def test_grayscale_and_hsv_match(rng):
    x = rng.uniform(0, 1, (4, 3, 5, 5)).astype(np.float32)
    x[0, :, 0, 0] = [0.5, 0.5, 0.5]  # gray: hue and saturation 0
    x[0, :, 0, 1] = 0.0  # black
    want_g = np.stack([np.asarray(jdev._grayscale(jnp.asarray(c)))
                       for c in x])
    np.testing.assert_allclose(tdev._grayscale(torch.from_numpy(x)).numpy(),
                               want_g, atol=TOL)
    hsv = tdev._rgb_to_hsv(torch.from_numpy(x))
    want_hsv = np.stack([np.asarray(jdev._rgb_to_hsv(jnp.asarray(c)))
                         for c in x])
    np.testing.assert_allclose(hsv.numpy(), want_hsv, atol=TOL)
    back = tdev._hsv_to_rgb(hsv).numpy()
    want_back = np.stack([np.asarray(jdev._hsv_to_rgb(jnp.asarray(c)))
                          for c in want_hsv])
    np.testing.assert_allclose(back, want_back, atol=TOL)
    np.testing.assert_allclose(back, x, atol=TOL)


def test_color_jitter_matches_in_every_order(rng):
    """Every crop gets its own op order (24 of them over 48 crops) and
    factors; hue shifts of both signs."""
    import itertools

    perms = np.array(list(itertools.permutations(range(4))) * 2, np.int32)
    n = len(perms)
    x = rng.uniform(0, 1, (n, 3, 6, 6)).astype(np.float32)
    fb = rng.uniform(0.6, 1.4, n).astype(np.float32)
    fc = rng.uniform(0.6, 1.4, n).astype(np.float32)
    fs = rng.uniform(0.8, 1.2, n).astype(np.float32)
    fh = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    want = np.asarray(jax.vmap(jdev._color_jitter_one)(
        *(jnp.asarray(a) for a in (x, perms, fb, fc, fs, fh))))
    got = tdev._color_jitter(*(torch.from_numpy(a) for a in
                               (x, perms.astype(np.int64), fb, fc, fs, fh)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("size", [16, 96])
def test_blur_matrix_and_blur_match(rng, size):
    sigma = np.array([0.1, 0.7, 1.3, 2.0], np.float32)
    m = tdev._blur_matrix(torch.from_numpy(sigma), size, 13).numpy()
    for i, s in enumerate(sigma):
        np.testing.assert_allclose(
            m[i], np.asarray(jdev._blur_matrix(jnp.float32(s), size, 13)),
            atol=1e-6)
    np.testing.assert_allclose(m.sum(axis=2), 1.0, atol=1e-6)
    x = rng.uniform(0, 1, (4, 3, size, size)).astype(np.float32)
    got = tdev._blur(torch.from_numpy(x), torch.from_numpy(sigma), 13)
    want = np.stack([np.asarray(jdev._blur_one(jnp.asarray(x[i]),
                                               jnp.float32(s), 13))
                     for i, s in enumerate(sigma)])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("scale", [(0.4, 1.0), (0.05, 0.4)])
def test_boxes_in_bounds_and_in_scale(scale):
    """tpu_ac's own statistics of its boxes (tests/test_device_aug.py)."""
    gen = torch.Generator().manual_seed(0)
    n, size = 2048, 256
    top, left, ch, cw = (v.numpy() for v in
                         tdev._sample_boxes(gen, n, size, scale))
    assert (top >= 0).all() and (left >= 0).all()
    assert (top + ch <= size).all() and (left + cw <= size).all()
    assert (ch >= 1).all() and (cw >= 1).all()
    areas = ch * cw / size ** 2
    lo, hi = scale
    assert np.mean((areas > lo * 0.95) & (areas < hi * 1.01)) > 0.95
    ratio = cw / ch
    assert (ratio > 0.7).all() and (ratio < 1.43).all()
    # the same distribution as tpu_ac's boxes: mean area within 2%
    j = [np.asarray(v) for v in jdev._sample_boxes(
        jax.random.PRNGKey(0), n, size, scale)]
    assert abs(areas.mean() - (j[2] * j[3] / size ** 2).mean()) < 0.02 * hi


CFG = tdev.DeviceAugConfig(local_crops_number=3, global_size=32,
                           local_size=16, base_size=64)


def _base(rng, b=4):
    return torch.from_numpy(rng.integers(0, 255, (b, 3, 64, 64),
                                         dtype=np.uint8))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_program_shapes_order_and_dtype(rng):
    g, l = tdev.device_multicrop(_base(rng), _gen(0), CFG)
    assert g.shape == (8, 3, 32, 32) and g.dtype == torch.float32
    assert l.shape == (12, 3, 16, 16) and l.dtype == torch.float32
    # crop-major: row b of each slot crops image b.  Identical base images
    # apart from image 0 show it: only rows 0, 4 (globals) and 0, 4, 8
    # (locals) may differ from the rest's distribution of means.
    base = torch.zeros(4, 3, 64, 64, dtype=torch.uint8)
    base[0] = 255
    g, l = tdev.device_multicrop(base, _gen(1), CFG)
    un = g * torch.tensor(IMAGENET_STD)[:, None, None] + \
        torch.tensor(IMAGENET_MEAN)[:, None, None]
    bright = un.mean(dim=(1, 2, 3)) > 0.5
    # solarize may invert the second global of a white image
    assert bright[0] and not bright[[1, 2, 3, 5, 6, 7]].any()
    unl = l * torch.tensor(IMAGENET_STD)[:, None, None] + \
        torch.tensor(IMAGENET_MEAN)[:, None, None]
    assert (unl.mean(dim=(1, 2, 3)) > 0.5).nonzero().flatten().tolist() == \
        [0, 4, 8]


def test_program_deterministic_per_seed(rng):
    base = _base(rng)
    g1, l1 = tdev.device_multicrop(base, _gen(7), CFG)
    g2, l2 = tdev.device_multicrop(base, _gen(7), CFG)
    assert torch.equal(g1, g2) and torch.equal(l1, l2)
    g3, _ = tdev.device_multicrop(base, _gen(8), CFG)
    assert not torch.equal(g1, g3)
    assert not torch.allclose(g1[0], g1[4])  # the two globals of image 0


def test_program_range_and_no_locals(rng):
    g, l = tdev.device_multicrop(_base(rng), _gen(0), CFG)
    for arr in (g, l):
        un = arr * torch.tensor(IMAGENET_STD)[:, None, None] + \
            torch.tensor(IMAGENET_MEAN)[:, None, None]
        assert un.min() > -1e-4 and un.max() < 1.0 + 1e-4
    g, l = tdev.device_multicrop(
        _base(rng), _gen(0), dataclasses.replace(CFG, local_crops_number=0))
    assert l is None and g.shape[0] == 8


def test_blur_and_solarize_rates_per_slot():
    """A flat gray base isolates two ops: the blur leaves it flat, and the
    solarize inverts it (p 0.2 on the second global only)."""
    b = 512
    base = torch.full((b, 3, 16, 16), 200, dtype=torch.uint8)
    cfg = dataclasses.replace(CFG, global_size=8, local_crops_number=0,
                              base_size=16)
    g, _ = tdev.device_multicrop(base, _gen(3), cfg)
    un = g * torch.tensor(IMAGENET_STD)[:, None, None] + \
        torch.tensor(IMAGENET_MEAN)[:, None, None]
    dark = un.mean(dim=(1, 2, 3)) < 0.3
    assert not dark[:b].any()  # the first global is never solarized
    assert 0.12 < dark[b:].float().mean() < 0.28


def test_load_base_image_equal(rng):
    img = Image.fromarray(rng.integers(0, 255, (80, 120, 3)).astype(
        np.uint8))
    np.testing.assert_array_equal(tdev.load_base_image(img, 64),
                                  jdev.load_base_image(img, 64))
    base = rng.integers(0, 255, (3, 24, 24)).astype(np.uint8)
    assert tdev.load_base_image(base, 24) is base
    with pytest.raises(ValueError):
        tdev.load_base_image(base, 32)
    with pytest.raises(ValueError):
        tdev.load_base_image(base.astype(np.float32), 24)


def _folder(root, rng, n=3):
    (root / "a").mkdir(parents=True)
    for i in range(n):
        arr = rng.integers(0, 255, (30, 40, 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / "a" / f"{i}.png")
    return ImageFolder(str(root))


def test_build_base_cache_equals_tpu_ac_and_reuses(rng, tmp_path):
    ds = _folder(tmp_path / "data", rng)
    cache = tdev.build_base_cache(ds, 24, str(tmp_path / "c"))
    want = jdev.build_base_cache(ds, 24, str(tmp_path / "j"))
    np.testing.assert_array_equal(np.asarray(cache), np.asarray(want))
    # the same key: tpu_ac names its file alike
    assert os.listdir(tmp_path / "c") == os.listdir(tmp_path / "j")
    again = tdev.build_base_cache(ds, 24, str(tmp_path / "c"))
    np.testing.assert_array_equal(np.asarray(again), np.asarray(cache))
    assert len(os.listdir(tmp_path / "c")) == 1


def test_failed_build_keeps_its_error(rng, tmp_path, monkeypatch):
    """A decode that fails mid-build removes the temp file and raises its
    own error; when removing the temp file fails too, the decode's error
    still surfaces, not the unlink's."""
    ds = _folder(tmp_path / "data", rng)

    class Flaky:
        samples = ds.samples

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("truncated file")
            return ds[i]

    cache_dir = tmp_path / "cache"
    with pytest.raises(KeyError, match="truncated"):
        tdev.build_base_cache(Flaky(), 16, str(cache_dir))
    assert not any(".tmp" in p for p in os.listdir(cache_dir))

    def bad_unlink(path):
        raise PermissionError(f"cannot remove {path}")

    monkeypatch.setattr(tdev.os, "unlink", bad_unlink)
    with pytest.raises(KeyError, match="truncated"):
        tdev.build_base_cache(Flaky(), 16, str(cache_dir))
    monkeypatch.undo()
    for p in os.listdir(cache_dir):
        with contextlib.suppress(OSError):
            os.unlink(cache_dir / p)
    out = tdev.build_base_cache(ds, 16, str(cache_dir))
    assert out.shape == (3, 3, 16, 16)
