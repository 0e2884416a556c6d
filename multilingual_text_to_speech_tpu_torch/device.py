"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  There is
no silent move to the CPU: asking for ``cuda`` on a machine without a card
raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def exact_float32():
    """cuDNN's float32 convolutions and LSTMs in full float32 inside the
    block: PyTorch lets cuDNN run them in TF32 (10-bit mantissas) by
    default (``torch.backends.cudnn.allow_tf32``), which the float32
    compute type must not.  The setting is restored on leaving; matrix
    products are float32 by PyTorch's default already."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old
