"""Device resolution: the port runs on the card unless told otherwise.

Every entry point of the package takes a ``device`` argument and passes
it through :func:`resolve_device`.  ``None`` and ``"cuda"`` mean the
first CUDA device; ``"cpu"`` is honoured only when the caller names it
(the CPU tests do, to run the plain PyTorch versions of the kernels).
There is no silent fallback: asking for the card on a machine without
one raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> that CUDA device, or raise
    ``RuntimeError`` naming the missing device; ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: the port runs "
                         f"on 'cuda' or, when asked, on 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available (torch.cuda.is_available() is False); pass "
            f"device='cpu' to run the plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_report(device: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    for the card behind a CUDA ``device``; ``None`` on the CPU."""
    if device.type != "cuda":
        return None
    import subprocess

    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.splitlines()
    return lines[0].strip()
