"""The host and the device an executor runs on.

The port's copy of ``device_memory_budget`` and ``host_load`` in
``arrow_matrix_tpu/utils/platform.py`` and of ``gather_budget_for`` in
``arrow_matrix_tpu/parallel/multi_level.py``: the byte budgets that
``MultiLevelArrow(fmt="auto")`` compares dense block footprints with,
and that bound the plain ELL gathers' intermediate; the host's load
beside a measurement; and :func:`probe_card`, the counterpart of the
reference's ``probe_default_backend``, which asks a subprocess with a
timeout whether the card answers, so that a card that hangs costs the
timeout and not the caller.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch


def device_memory_budget(device: torch.device, fraction: float = 0.5,
                         default: int = 4 << 30) -> int:
    """Bytes available for resident block storage on ``device``, from
    the live device rather than a constant: the card's free memory
    (``torch.cuda.mem_get_info``) times ``fraction``; on the CPU the
    available host RAM times ``fraction`` (``sysconf``, the reference's
    rule); ``default`` only when neither is known.  ``fraction`` leaves
    headroom for the features and the kernels' scratch."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(int(free * fraction), 0)
    try:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return max(int(free * fraction), 0)
    except (ValueError, OSError, AttributeError):
        return default


def gather_budget_for(dense_budget: int) -> int:
    """Byte budget of the plain ELL gathers' intermediate, derived from
    the dense-format budget (the reference's rule)."""
    return max(dense_budget // 4, 1 << 27)


def host_load(max_pids: int = 8) -> dict:
    """Competing host activity at the time of a measurement:
    ``{"loadavg_1m": float, "competing": [process names...]}``, where
    ``competing`` lists up to ``max_pids`` other processes in the
    runnable or uninterruptible state (R/D).  Linux fields degrade to
    empty elsewhere; never raises."""
    try:
        load1 = os.getloadavg()[0]
    except (OSError, AttributeError):  # pragma: no cover - non-unix
        load1 = -1.0
    names: list = []
    me = os.getpid()
    try:
        for pid in os.listdir("/proc"):
            if not pid.isdigit() or int(pid) == me:
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            # comm may hold spaces and parentheses: it ends at the LAST
            # ')'; the state letter is the first field after it.
            close = stat.rfind(")")
            if close < 0:
                continue
            comm = stat[stat.find("(") + 1:close]
            rest = stat[close + 1:].split()
            if rest and rest[0] in ("R", "D"):
                names.append(comm)
                if len(names) >= max_pids:
                    break
    except OSError:  # pragma: no cover - /proc absent
        pass
    return {"loadavg_1m": round(float(load1), 2), "competing": names}


#: Exit code of the probe child when PyTorch sees no CUDA device (no
#: retry helps then).
NO_CARD_RC = 3

_PROBE = ("import sys, torch\n"
          "if not torch.cuda.is_available():\n"
          "    sys.exit(%d)\n"
          "d = torch.device('cuda', 0)\n"
          "x = torch.arange(16384, dtype=torch.float32, device=d)\n"
          "v = float(x.sum())\n"
          "print(d.type)\n"
          "print(torch.cuda.get_device_name(0))\n" % NO_CARD_RC)


def probe_card(timeout_s: float = 60.0, retries: int = 2
               ) -> tuple:
    """Whether the first CUDA device answers: a subprocess makes a 64 KB
    tensor on it and reads back its sum, under a hard timeout.

    Returns ``(platform, device_kind, error)``: ``("cuda",
    torch.cuda.get_device_name(0), None)`` when the card answers, else
    ``("cpu", "host", error)`` with the last failure.  A machine with no
    CUDA device fails at once; a crash or a timeout is retried up to
    ``retries`` times."""
    err = None
    for attempt in range(max(retries, 1)):
        try:
            proc = subprocess.run([sys.executable, "-c", _PROBE],
                                  capture_output=True, text=True,
                                  timeout=timeout_s)
            lines = [ln.strip() for ln in proc.stdout.splitlines()
                     if ln.strip()]
            if proc.returncode == 0 and len(lines) >= 2:
                return lines[-2], lines[-1], None
            if proc.returncode == NO_CARD_RC:
                return ("cpu", "host", "no CUDA device "
                        "(torch.cuda.is_available() is False)")
            err = (f"card probe rc={proc.returncode}: "
                   f"{proc.stderr.strip()[-400:]}")
        except subprocess.TimeoutExpired:
            err = f"card probe timed out after {timeout_s:.0f}s"
        if attempt < retries - 1:
            time.sleep(min(5.0 * 2 ** attempt, 30.0))
    return "cpu", "host", err
