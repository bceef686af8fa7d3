"""The granule gather probe: K4 against the library gather, on the
card.

Counterpart of ``tools/pallas_gather_probe.py``.  Features are packed
so that 8 consecutive rows of 16 f32 features form one contiguous
512-byte line, ``(n / 8, 128)``; three variants gather the same random
rows:

1. ``torch_take``    -- ``ops.gather.take``, one PyTorch call
                        (row-major ``index_select``);
2. ``torch_granule`` -- ``ops.gather.granule_gather_plain``: a gather
                        of whole granule lines, then the sub-row select
                        (the TPU kernel's way, in plain PyTorch);
3. ``cuda_granule``  -- K4, ``ops.cuda_gather.granule_gather``: the row
                        gather on the ``(n, 16)`` view of the lines.

    python -m arrow_matrix_tpu_torch.tools.granule_gather_probe
    python -m arrow_matrix_tpu_torch.tools.granule_gather_probe --device cpu

On the card: n = 2^20 rows, S = 2^21 slots, seed 5; each variant's
time is the median of 20 calls timed by CUDA events.  ``--device cpu``
takes n = 2^14, S = 2^12; there the kernel variant runs its plain
version and the times are the host's.  The record also carries the JAX
probe's ``block`` and ``wave`` (its TPU kernel's grid step and copies
in flight; they configure nothing here) and the granule design's line
traffic.  Prints one JSON line.  ``cuda_vs_torch`` and ``verdict`` are
written only when the device is a card and both ``torch_take`` and
``cuda_granule`` gathered exactly.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from arrow_matrix_tpu_torch.ops import cuda_gather
from arrow_matrix_tpu_torch.ops.gather import (
    C,
    K,
    granule_gather_plain,
    pack_granules,
    take,
)
from arrow_matrix_tpu_torch.utils import card_report, resolve_device
from arrow_matrix_tpu_torch.utils.timing import median_ms

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory

#: (n, slots, block, wave) on the card and on the CPU: the JAX probe's
#: shapes, with its TPU kernel's blocking as record fields.
SHAPES = {"cuda": (1 << 20, 1 << 21, 1024, 32),
          "cpu": (1 << 14, 1 << 12, 64, 16)}


def gather_traffic(idx: np.ndarray) -> dict:
    """The least traffic of ``x[idx]`` at k = 16 f32: each distinct row
    read once (64 B), each slot's row written once (64 B), each index
    read once (4 B); and the line traffic of the TPU kernel's granule
    design (S x 512 B).  The least traffic over the card's memory rate
    is K4's bound."""
    distinct = int(np.unique(idx).size)
    return {"distinct_rows": distinct,
            "bytes": distinct * 4 * K + idx.size * (4 * K + 4),
            "line_bytes": idx.size * 4 * K * C}


def run_probe(device=None, n=None, slots=None, seed: int = 5,
              reps: int = 20) -> dict:
    """Time the three variants on ``device`` (the card unless ``"cpu"``)
    at the shapes of :data:`SHAPES` unless given; returns the record
    that :func:`main` prints."""
    dev = resolve_device(device)
    dn, ds, block, wave = SHAPES[dev.type]
    n, slots = n or dn, slots or ds
    out = {"metric": "granule_gather_probe", "platform": dev.type,
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "card": card_report(dev), "n": n, "slots": slots, "k": K,
           "granule": C, "block": block, "wave": wave, "seed": seed,
           "timer": ("cuda events" if dev.type == "cuda"
                     else "host clock"),
           "variants": {}}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, K)).astype(np.float32)
    idx = rng.integers(0, n, size=slots, dtype=np.int32)
    want = x[idx]
    x_d = torch.from_numpy(x).to(dev)
    x_packed = pack_granules(x_d)
    idx_d = torch.from_numpy(idx).to(dev)
    out.update(gather_traffic(idx))
    if dev.type == "cuda":
        out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3

    variants = {
        "torch_take": lambda: take(x_d, idx_d),
        "torch_granule": lambda: granule_gather_plain(x_packed, idx_d),
        "cuda_granule": lambda: cuda_gather.granule_gather(x_packed,
                                                           idx_d),
    }
    for name, fn in variants.items():
        got = fn().reshape(-1, K).cpu().numpy()
        rec = {"exact": bool(np.array_equal(got, want))}
        if not rec["exact"]:
            rec["max_err"] = float(np.abs(got - want).max())
        ms = median_ms(fn, reps, dev)
        rec.update(ms=ms, mslots_s=slots / ms / 1e3)
        out["variants"][name] = rec
    v = out["variants"]
    # The verdict needs a card and both gathers exact: a fast kernel
    # that returns wrong rows, or a host timing, never reads "wins".
    if dev.type == "cuda" and all(v[name]["exact"] for name in
                                  ("torch_take", "cuda_granule")):
        ratio = v["cuda_granule"]["mslots_s"] / v["torch_take"]["mslots_s"]
        out["cuda_vs_torch"] = ratio
        out["verdict"] = ("cuda_wins — productionize" if ratio > 1.1
                          else "torch_holds")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print(json.dumps(run_probe(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
