"""Flash (streaming-softmax) attention for the ViT trunk: wrapper of the CUDA
kernels ``csrc/flash_attention.cu`` and their plain PyTorch version (port of
``tpu_ac.kernels.attention.flash_attention_impl``).

    out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] * scale) v[b, h, j]

over the keys j visible to query i.  ``attn_bias`` keeps ``tpu_ac``'s
contract: ``None`` or a batch-uniform [1, ..., 1, S] additive key mask,
which becomes the segment ids of the stock TPU kernel (``bias < -1`` gives
1, else 0; key j is visible to query i only if their ids are equal, so a
padded query row sees only the padded keys).  A per-batch or wrong-length
bias raises ``NotImplementedError``, as in ``tpu_ac``.

A CUDA tensor launches a kernel or raises; a CPU tensor runs
``flash_attention_plain``.  The kernels take any S (the ragged tail is
masked in the kernel, not padded) and any head dim whose query tile fits
a block's shared memory with every column (``flash_by_slices``; on an
H100 up to 768 in bf16 and 512 in f32, past which the launch fails and
raises): Dh <= 64 is zero-padded to 64 (``pad_head_dim``, as
``tpu_ac`` pads to 128 lanes; zero columns change neither QK^T nor the kept
columns of the output) and runs the Dh = 64 kernels; over 64, Dh is padded
only to a multiple of 8 (16-byte rows) and the wide kernels compute QK^T
over every column once per key tile, in one launch for Dh <= 256 and one
per 256-column slice of V and the output above.  bf16 runs on the tensor
cores in bf16 (the wide kernel on wgmma with TMA), f32 in 3xTF32 (f32
accuracy).  It reads q, k, v through their strides, so the strided views of
a packed qkv projection go in without a copy; what it cannot address (a
last dim that is not contiguous, rows not 16-byte aligned) raises instead
of being copied.  The output is [B, H, S, Dh] laid out as [B, S, H, Dh] in
memory, the layout the output projection reads.  The TPU tuning knobs
(``TPU_AC_FLASH_BLOCK_*``) are not carried.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches made by flash_attention_impl (CUDA tensors only); of them
# the f32 variant's, and those of the kernels for head dims over 64
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_WIDE = 0

HEAD_DIM = 64  # the Dh = 64 kernels' head dim (every dino_vit* name's Dh)
WIDE_ALIGN = 8  # over 64, Dh is padded to a multiple of this (16-byte rows)
WIDE_SLICE = 256  # V and output columns a wide launch takes at most
_DTYPES = (torch.bfloat16, torch.float32)
_STRIDES = ctypes.c_longlong * 12


def bias_to_segment_ids(attn_bias: torch.Tensor | None,
                        s: int) -> torch.Tensor | None:
    """The additive key mask -> int32 [S] segment ids (``tpu_ac``'s
    conversion), or None."""
    if attn_bias is None:
        return None
    if attn_bias.shape[-1] != s or any(d != 1 for d in attn_bias.shape[:-1]):
        raise NotImplementedError(
            "flash attention_impl supports only a batch-uniform "
            f"[1, ..., 1, S] key mask; got {tuple(attn_bias.shape)}. "
            "Per-batch or truly additive biases need the dense path.")
    return (attn_bias.reshape(-1) < -1.0).to(torch.int32)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v of one shape [B, H, S, Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want q, k, v all bfloat16 or all float32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float,
                          segment_ids: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Dense softmax(QK^T * scale + segment mask) V, upcast to f32 and cast
    back to the input type."""
    _check(q, k, v)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-2, -1)) * scale
    if segment_ids is not None:
        ids = segment_ids.to(q.device)
        logits = logits.masked_fill(ids[:, None] != ids[None, :],
                                    float("-inf"))
    return torch.matmul(torch.softmax(logits, dim=-1), vf).to(q.dtype)


# bf16's unit roundoff (8 significant bits)
_BF16_U = 2.0 ** -8
# f32 variant: gap over the attention of |V|
_F32_RTOL = 1e-5


def flash_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, segment_ids: torch.Tensor | None,
                    want: torch.Tensor) -> torch.Tensor:
    """Per element, the largest gap the kernel may have from ``want``, the
    plain version's output on the same inputs (f32).

    Both sides compute o = sum_j p_j v_j / l from the same logits in f32;
    let m = sum_j p_j |v_j| / l, the plain attention of |V|.
      - bf16: the kernel rounds each p_j to bf16 before P.V (relative u =
        2^-8; l sums the unrounded p), which moves o by at most u m; then
        each side rounds its f32 o to bf16 once (u |o| each).  So the
        outputs differ by at most u m + 2u |want| to first order, held with
        5% over it for the f32 sums in another order and exp2 for exp
        (about 1e-6 of m).
      - f32: the same sums in another order and exp2 for exp; 1e-5 m, about
        6x the sqrt(S) u_f32 m spread of such sums at S = 785.
    At [8, 12, 785, 64] with unit-variance q, k, v, m is about 0.8 and
    |out| about 0.05, so the bf16 limit is about 3.5e-3 an element, while a
    kernel that drops the 17 keys of the ragged tile is off by up to 0.05.
    """
    f = [t.to(torch.float32) for t in (q, k, v)]
    m = flash_attention_plain(f[0], f[1], f[2].abs(), scale, segment_ids)
    if q.dtype == torch.bfloat16:
        return 1.05 * _BF16_U * (m + 2.0 * want.to(torch.float32).abs())
    return _F32_RTOL * m


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from tpu_ac_torch.kernels.build import library

        fn = library("flash_attention").tpu_ac_flash_attention
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, vp]
        fn.restype = ci
        _FN = fn
    return _FN


def _check_layout(name: str, t: torch.Tensor) -> None:
    """The kernel reads rows of Dh contiguous values with 16-byte loads."""
    step = 16 // t.element_size()
    sb, sh, ss, sd = t.stride()
    nb, nh, ns, _ = t.shape
    if (sd != 1 or t.data_ptr() % 16 or (nb > 1 and sb % step)
            or (nh > 1 and sh % step) or (ns > 1 and ss % step)):
        raise ValueError(
            f"{name}: the kernel needs a contiguous last dim and 16-byte "
            f"aligned rows; got strides {t.stride()} at offset "
            f"{t.data_ptr() % 16} (mod 16)")


def padded_head_dim(d: int) -> int:
    """The width the kernels take for a head dim of ``d``: 64 up to 64,
    else ``d`` rounded up to a multiple of WIDE_ALIGN."""
    if d <= HEAD_DIM:
        return HEAD_DIM
    return -(-d // WIDE_ALIGN) * WIDE_ALIGN


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """[..., Dh] -> [..., padded_head_dim(Dh)] with zero columns (``t``
    itself where Dh is that width already)."""
    pad = padded_head_dim(t.shape[-1]) - t.shape[-1]
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def flash_by_slices(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    launch) -> torch.Tensor:
    """The kernels' head-dim plan: q, k, v zero-padded to
    ``padded_head_dim``, then ``launch(q, k, v_j, out_j)`` once for each
    WIDE_SLICE-column slice j of V and of the output, which it fills (one
    launch on the whole tensors up to WIDE_SLICE columns); q and k always go
    in whole.  Returns the output [B, H, S, Dh], laid out as [B, S, H, Dh']
    (Dh' the padded width) in memory, sliced back to Dh."""
    b, h, s, d = q.shape
    q, k, v = pad_head_dim(q), pad_head_dim(k), pad_head_dim(v)
    dp = q.shape[-1]
    out = torch.empty_strided((b, h, s, dp), (s * h * dp, dp, h * dp, 1),
                              dtype=q.dtype, device=q.device)
    if dp <= WIDE_SLICE:  # one launch on the tensors themselves
        launch(q, k, v, out)
    else:
        for j in range(0, dp, WIDE_SLICE):
            launch(q, k, v[..., j:j + WIDE_SLICE],
                   out[..., j:j + WIDE_SLICE])
    return out if dp == d else out[..., :d]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, scale: float, ids: torch.Tensor | None
            ) -> None:
    """One kernel launch: q, k [B, H, S, Dqk] and v, out [B, H, S, Dv]
    (Dqk = Dv = 64: the Dh = 64 kernels; else the wide ones)."""
    global LAUNCHES, LAUNCHES_F32, LAUNCHES_WIDE
    b, h, s, dqk = q.shape
    dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    strides = _STRIDES(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *out.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ids is None else ids.data_ptr(), strides, b, h, s, dqk,
            dv, float(scale), int(q.dtype == torch.bfloat16))
    fn = _kernel_fn()
    dev = q.device
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_F32 += q.dtype == torch.float32
    LAUNCHES_WIDE += dqk != HEAD_DIM


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, ids: torch.Tensor | None) -> torch.Tensor:
    b, h, _, _ = q.shape
    if not scale > 0:
        raise ValueError(
            f"the flash kernel takes a positive scale, got {scale}")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b}, H={h}: each must be <= 65535 (grid)")
    if ids is not None:
        ids = ids.to(device=q.device, dtype=torch.int32).contiguous()
    return flash_by_slices(
        q, k, v, lambda q, k, v, out: _launch(q, k, v, out, scale, ids))


def flash_attention_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float,
                         attn_bias: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """softmax(QK^T * scale)V -> [B, H, S, Dh] in the input type.

    q, k, v: [B, H, S, Dh], all bfloat16 or all float32, on one device.  On
    CUDA this launches the kernel (or raises); on the CPU it runs the plain
    version.
    """
    _check(q, k, v)
    ids = bias_to_segment_ids(attn_bias, q.shape[2])
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, scale, ids)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, ids)
    raise ValueError(f"unsupported device {q.device}")
