"""Row gathers: the plain versions of K4, the library yardstick, and
the granule layout.

Counterpart of the non-kernel code of ``tools/pallas_gather_probe.py``.
K4 (``ops/cuda_gather.py``) gathers rows, ``out[s] = x[idx[s]]``, and
adds them to a base in place; :func:`row_gather_plain` and
:func:`row_gather_add_plain` are its plain PyTorch versions, which the
wrappers run for CPU tensors.

The granule layout of the TPU kernel packs ``C = 8`` consecutive rows
of ``K = 16`` f32 features into one contiguous 512-byte line, so that
``(n, 16)`` features are viewed as ``(n / 8, 128)`` lines; the TPU
kernel moves whole lines and picks the wanted sub-row afterwards.
:func:`granule_gather_plain` computes that way (as the JAX package's
``xla_granule``).
"""

from __future__ import annotations

import torch

C = 8          # rows per granule: 8 x 16 features x f32 = 512-byte lines
K = 16         # features per row
LANES = C * K  # 128 floats per granule line


def pack_granules(x: torch.Tensor) -> torch.Tensor:
    """The ``(n, 16)`` -> ``(n / 8, 128)`` granule view of contiguous
    features (no copy); raises unless ``n % 8 == 0``."""
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x must be (n, {K}), got {tuple(x.shape)}")
    if x.shape[0] % C:
        raise ValueError(f"n = {x.shape[0]} rows is not a multiple of the "
                         f"granule ({C} rows)")
    return x.contiguous().view(x.shape[0] // C, LANES)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` over rows: one PyTorch call, the gather probes'
    yardstick.

    Row-major ``x.index_select(0, idx)``, where the JAX package's
    ``xla_take`` gathers columns of a feature-major ``(k, n)`` array.
    The port's carriage, and the gathers of its SELL kernel, are
    row-major, so its yardstick gathers rows."""
    return x.index_select(0, idx)


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4's plain version: ``out[s] = x[idx[s]]`` over rows."""
    return x.index_select(0, idx)


def row_gather_add_plain(base: torch.Tensor, x: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """K4's fused form, plain: ``base[s] += x[idx[s]]`` in place (one f32
    addition, the base first); returns ``base``."""
    return base.add_(x.index_select(0, idx))


def granule_gather_plain(x_packed: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's way, in plain PyTorch: ``out.reshape(S, 16)[s] =
    x[idx[s]]`` from packed ``x_packed (n / 8, 128)`` f32 and ``idx
    (S,)`` int32, returned packed as ``(S / 8, 128)`` (``S % 8 == 0``).

    As the JAX ``xla_granule``: gather the granule lines ``idx // 8``,
    then select the sub-row ``idx % 8`` by a mask and a sum over the 8
    segments of a line.  The sum turns a ``-0.0`` into ``+0.0`` (K4
    copies the row's bits), so compare the two by value."""
    if idx.shape[0] % C:
        raise ValueError(f"S = {idx.shape[0]} slots is not a multiple of "
                         f"{C}")
    g = x_packed.index_select(0, torch.div(idx, C, rounding_mode="floor"))
    off = torch.remainder(idx, C)
    lane = torch.arange(LANES, device=idx.device) // K
    masked = torch.where(lane[None, :] == off[:, None], g,
                         torch.zeros((), dtype=g.dtype, device=g.device))
    return masked.view(-1, C, K).sum(dim=1).view(-1, LANES)
