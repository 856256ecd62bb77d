"""Device selection for the port (counterpart of
longcalld_tpu/utils/device.py:15-40, which set up the XLA compile cache and
re-pinned the JAX platform; neither exists under PyTorch).

The device is explicit: callers pass a ``torch.device`` (or its string),
defaulting to ``cuda:0``.  Asking for CUDA on a machine without it raises;
there is no silent CPU fallback.  A CPU device is only ever used because a
caller asked for it (the tests run the kernels' plain versions that way).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda:0"


def resolve_device(device=None) -> torch.device:
    """Return the torch.device to run on; for CUDA, check it exists and turn
    TF32 off (the phasing EM's float32 dots are exact only in full fp32)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' or run host-only (use_device=False)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
