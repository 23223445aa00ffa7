"""Device selection, the embed precision scope and the card report.

No silent CPU fallback: an entry point runs on ``cuda`` unless the caller
asks for ``cpu``, and asking for ``cuda`` on a machine without a card
raises.  ``card_report`` is the part of ``tpu_ac.utils.tpu`` that has a
meaning on the card (its backend retry and compile cache do not apply to
CUDA): the name, count and power limit that every measurement stands
beside.
"""

from __future__ import annotations

import contextlib
import subprocess

import torch

PRECISIONS = ("default", "highest", "bfloat16")


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` -> torch.device; raises when CUDA
    is asked for and absent.  A bare ``"cuda"`` becomes the calling
    thread's current card, with its index: the current card is a
    thread's, so a loader thread would put a bare ``"cuda"`` on card 0
    where a rank of a process group (``distributed.multihost_init``) has
    made another card current."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but CUDA is not available; "
            "pass device='cpu' (CLI: --device cpu) to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {str(name)!r}; want 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def embed_dtype(precision: str) -> torch.dtype:
    """Storage/compute dtype of the embed for a PipelineConfig.precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; want one of {PRECISIONS}")
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


@contextlib.contextmanager
def precision_scope(precision: str):
    """TF32 switches for the duration of one embed call.

    "highest" turns TF32 off for both cuBLAS matmuls and cuDNN convs (the
    fused pool conv goes through cuDNN, whose f32 default IS TF32);
    "default" allows TF32, the card's analogue of the TPU's single-pass
    DEFAULT; "bfloat16" computes in bf16, where the switches do not apply.
    The previous settings are restored on exit.
    """
    embed_dtype(precision)  # validates
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    allow = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def parse_card_report(text: str) -> dict:
    """{"name", "power_limit", "count", "line"} from the output of
    ``CARD_QUERY`` (one "name, limit" line a card; ``line`` is the first,
    as nvidia-smi gives it)."""
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    name, _, limit = lines[0].rpartition(",")
    if not name:
        raise RuntimeError(f"unexpected nvidia-smi line {lines[0]!r}")
    return {"name": name.strip(), "power_limit": limit.strip(),
            "count": len(lines), "line": lines[0]}


def card_report() -> dict:
    """The cards' name, count and power limit (``parse_card_report``), as
    ``nvidia-smi`` reads them; raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is "
                           "false")
    try:
        out = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    return parse_card_report(out)
