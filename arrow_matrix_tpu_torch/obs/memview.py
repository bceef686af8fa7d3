"""The executors' static HBM model, read by admission control.

The port's copy of the host half of ``arrow_matrix_tpu/obs/memview.py``:
:func:`tree_device_bytes` (bytes of the tensors in nested containers,
from their metadata), :func:`predicted_bytes_for` and
:func:`request_bytes_for` (an executor's own model of one step at a
feature width, and of one request's carriage on top of its resident
operator: the serving runtime's admission price), and
:func:`largest_fitting_repl`; and the measured side,
:func:`memory_report` / :func:`account_memory` /
:func:`format_memory_report`.  The JAX module reads those from a
compiled XLA executable's ``memory_analysis()``; here the function runs
once and the bytes are read around it (``source="cuda_allocator"`` on
the card, ``"tensors"`` on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from arrow_matrix_tpu_torch.obs import flight


def _leaves(node):
    """The tensors and numpy arrays in nested tuples, lists, dicts and
    dataclasses (their constructor fields only, so an operator's cached
    work lists are not its own)."""
    if isinstance(node, (torch.Tensor, np.ndarray)):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            if f.init:
                yield from _leaves(getattr(node, f.name))


def tree_device_bytes(*trees) -> int:
    """Total bytes of every tensor (or numpy array) in the given nested
    containers (:func:`_leaves`), from shape and dtype alone (no
    transfer).  Other leaves (None, scalars) count zero; a tensor met
    twice counts once."""
    seen = {}
    for leaf in _leaves(trees):
        if isinstance(leaf, torch.Tensor):
            seen[(leaf.data_ptr(), leaf.nbytes)] = leaf.nbytes
        else:
            seen[(id(leaf), leaf.nbytes)] = leaf.nbytes
    return int(sum(seen.values()))


def predicted_bytes_for(obj, k: int, itemsize: int = 4,
                        repl: int = 1) -> Optional[int]:
    """The executor's own static HBM model for one step at feature width
    ``k``, or None when it has no model.  ``repl`` is passed through
    (executors without the keyword get the model times ``repl``, the
    JAX package's planning convention)."""
    fn = getattr(obj, "predicted_hbm_bytes", None)
    if fn is None:
        return None
    repl = max(int(repl), 1)
    try:
        return int(fn(k, itemsize=itemsize, repl=repl))
    except TypeError:
        return int(fn(k, itemsize=itemsize)) * repl


def request_bytes_for(obj, k: int, itemsize: int = 4,
                      repl: int = 1) -> Optional[int]:
    """The incremental HBM bytes a request of feature width ``k`` adds
    on top of the executor's resident operator: the per-request
    admission price.  ``carriage_hbm_bytes`` answers directly where the
    executor has it; else the model at k minus the model at 0.  None
    when the executor has no model."""
    fn = getattr(obj, "carriage_hbm_bytes", None)
    if fn is not None:
        return int(fn(k, itemsize=itemsize, repl=repl))
    full = predicted_bytes_for(obj, k, itemsize=itemsize, repl=repl)
    base = predicted_bytes_for(obj, 0, itemsize=itemsize, repl=repl)
    if full is None or base is None:
        return None
    return max(int(full) - int(base), 0)


def largest_fitting_repl(base_bytes: int, budget_bytes: int,
                         choices=(1, 2, 4, 8)) -> int:
    """Largest replication factor whose footprint ``base_bytes * c``
    fits ``budget_bytes`` (at least 1)."""
    best = 1
    for c in sorted(set(int(c) for c in choices)):
        if c >= 1 and base_bytes * c <= budget_bytes:
            best = max(best, c)
    return best


def memory_report(fn, *args, **kwargs) -> Dict[str, Any]:
    """Device memory of one call ``fn(*args, **kwargs)``, run once.

    Returns ``{"source", "argument_bytes", "output_bytes",
    "temp_bytes", "generated_code_bytes", "alias_bytes",
    "total_bytes"}`` as the JAX package's does.  On the card
    (``source="cuda_allocator"``) the arguments' and the result's bytes
    come from their tensors, and the temporaries are the allocator's
    peak during the call (``reset_peak_memory_stats`` first) above what
    was allocated before it (the arguments among it), less the result.
    On the CPU (``source="tensors"``) the temporaries are unknown
    (None), as in the JAX package's ``"avals"`` fallback.  Generated
    code and aliases are None: a kernel library is not device memory
    the call allocates, and nothing is donated.
    """
    arg_bytes = tree_device_bytes(args, kwargs)
    on_card = any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                  for t in _leaves((args, kwargs)))
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    out_bytes = tree_device_bytes(out)
    temp = None
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        temp = max(int(peak) - int(base) - out_bytes, 0)
    report = {
        "source": "cuda_allocator" if on_card else "tensors",
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": temp,
        "generated_code_bytes": None,
        "alias_bytes": None,
    }
    report["total_bytes"] = arg_bytes + out_bytes + (temp or 0)
    return report


def account_memory(algorithm: str, fn, *args,
                   predicted_bytes: Optional[int] = None,
                   registry=None, **kwargs) -> Dict[str, Any]:
    """Account one call's device bytes against the executor's static
    model.  Returns ``{"algorithm", "report" (the full
    :func:`memory_report`), "measured_bytes", "predicted_bytes",
    "ratio", "source"}``; ``ratio`` is None without a (nonzero)
    prediction.  Sets the ``hbm_*`` gauges in ``registry`` and notes
    the report in the flight recorder."""
    report = memory_report(fn, *args, **kwargs)
    measured = report["total_bytes"]
    ratio = measured / predicted_bytes if predicted_bytes else None

    if registry is not None:
        registry.gauge("hbm_argument_bytes", algorithm=algorithm).set(
            report["argument_bytes"])
        registry.gauge("hbm_output_bytes", algorithm=algorithm).set(
            report["output_bytes"])
        if report["temp_bytes"] is not None:
            registry.gauge("hbm_temp_bytes", algorithm=algorithm).set(
                report["temp_bytes"])
        registry.gauge("hbm_measured_bytes", algorithm=algorithm).set(
            measured)
        if predicted_bytes is not None:
            registry.gauge("hbm_predicted_bytes",
                           algorithm=algorithm).set(predicted_bytes)
        if ratio is not None:
            registry.gauge("hbm_vs_predicted_ratio",
                           algorithm=algorithm).set(ratio)

    out = {
        "algorithm": algorithm,
        "report": report,
        "measured_bytes": measured,
        "predicted_bytes": predicted_bytes,
        "ratio": ratio,
        "source": report["source"],
    }
    rec = flight.get_recorder()
    if rec is not None:
        rec.note_memory_report({
            "algorithm": algorithm, "measured_bytes": measured,
            "predicted_bytes": predicted_bytes, "ratio": ratio,
            **report})
    return out


def format_memory_report(rep: Dict[str, Any]) -> str:
    """Human-readable lines for the CLIs' ``--mem_report``."""
    r = rep["report"]

    def mb(v):
        return "n/a" if v is None else f"{v / 2**20:.2f} MiB"

    lines = [
        f"per-device call memory ({rep['source']}):",
        f"  arguments      {mb(r['argument_bytes'])}",
        f"  outputs        {mb(r['output_bytes'])}",
        f"  temporaries    {mb(r['temp_bytes'])}",
        f"  generated code {mb(r['generated_code_bytes'])}",
        f"  total          {mb(rep['measured_bytes'])}",
    ]
    if rep["ratio"] is not None:
        lines.append(
            f"measured vs format-model prediction: "
            f"{rep['measured_bytes']} / {rep['predicted_bytes']} bytes "
            f"= {rep['ratio']:.2f}x")
    return "\n".join(lines)
