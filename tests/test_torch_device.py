"""tpu_ac_torch.device: the device rule (cuda unless cpu is asked for; no
silent fallback) and the TF32 scope of the embed.  No tolerances: these
are flags and errors."""

import pytest
import torch

from tpu_ac_torch.device import embed_dtype, precision_scope, resolve_device


def test_cpu_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()


def test_other_device_types_rejected():
    with pytest.raises(ValueError, match="want 'cuda' or 'cpu'"):
        resolve_device("meta")


@pytest.mark.parametrize("precision,dtype", [("default", torch.float32),
                                             ("highest", torch.float32),
                                             ("bfloat16", torch.bfloat16)])
def test_embed_dtype(precision, dtype):
    assert embed_dtype(precision) == dtype


def test_bad_precision_rejected():
    with pytest.raises(ValueError, match="precision"):
        embed_dtype("fp16")
    with pytest.raises(ValueError, match="precision"):
        with precision_scope("fp16"):
            pass


@pytest.mark.parametrize("precision,allow", [("highest", False),
                                             ("default", True),
                                             ("bfloat16", True)])
def test_precision_scope_sets_and_restores_tf32(precision, allow):
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not allow
        torch.backends.cudnn.allow_tf32 = not allow
        with precision_scope(precision):
            assert torch.backends.cuda.matmul.allow_tf32 is allow
            assert torch.backends.cudnn.allow_tf32 is allow
        assert torch.backends.cuda.matmul.allow_tf32 is (not allow)
        assert torch.backends.cudnn.allow_tf32 is (not allow)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


# card_report: the device report every measurement stands beside


def test_card_report_parses_nvidia_smi():
    from tpu_ac_torch.device import parse_card_report

    got = parse_card_report("NVIDIA H100 80GB HBM3, 700.00 W\n")
    assert got == {"name": "NVIDIA H100 80GB HBM3",
                   "power_limit": "700.00 W", "count": 1,
                   "line": "NVIDIA H100 80GB HBM3, 700.00 W"}
    four = parse_card_report("NVIDIA H100 80GB HBM3, 500.00 W\n" * 4)
    assert four["count"] == 4 and four["power_limit"] == "500.00 W"
    with pytest.raises(RuntimeError, match="no card"):
        parse_card_report("\n")


def test_card_report_raises_without_a_card(monkeypatch):
    from tpu_ac_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        device.card_report()
