"""Admission control: the live HBM accountant.

The port's copy of ``arrow_matrix_tpu/serve/admission.py``.  The
decomposed operator stays resident on the card across requests, so the
per-request memory is carriage: the executor's static model prices it
(``MultiLevelArrow.carriage_hbm_bytes`` through
``obs/memview.request_bytes_for``).  The accountant holds one budget:
the resident operator is charged once at server start, every admitted
request reserves its price before it is queued, and the reservation is
released when the ticket reaches a terminal state.  A request whose
price does not fit the remaining headroom is rejected explicitly,
never queued in hope.
"""

from __future__ import annotations

import threading
from typing import Optional

from arrow_matrix_tpu_torch.sync import guarded_by, witnessed


class ServeCapacityError(RuntimeError):
    """The configured HBM budget cannot even host the resident
    operator: the server refuses to start (serving from swap-in-denial
    is not graceful degradation)."""


@guarded_by("_lock", node="hbm_accountant",
            attrs=("in_use_bytes", "peak_in_use_bytes",
                   "resident_bytes"))
class HBMAccountant:
    """Thread-safe reserve/release ledger against one byte budget.

    ``budget_bytes`` is the total per-device budget; ``charge`` takes
    a permanent reservation (the resident operator), ``reserve`` a
    releasable one (request carriage).  ``reserve`` is
    all-or-nothing and exact: a request *exactly* at the remaining
    headroom is admitted (<=), one byte over is not.
    """

    def __init__(self, budget_bytes: int, registry=None,
                 name: str = "serve"):
        self.budget_bytes = int(budget_bytes)
        if self.budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got "
                             f"{budget_bytes}")
        self.in_use_bytes = 0
        self.peak_in_use_bytes = 0
        self.resident_bytes = 0
        self._lock = witnessed("hbm_accountant", threading.Lock())
        self._registry = registry
        self._name = name

    def _gauges(self) -> None:
        if self._registry is None:
            return
        self._registry.gauge("serve_hbm_in_use_bytes",
                             server=self._name).set(self.in_use_bytes)
        self._registry.gauge("serve_hbm_occupancy",
                             server=self._name).set(self.occupancy())

    def charge_resident(self, nbytes: int) -> None:
        """Permanent charge for the operator that stays HBM-resident
        across every request; raises :class:`ServeCapacityError` when
        it alone exceeds the budget."""
        nbytes = max(int(nbytes), 0)
        with self._lock:
            if self.in_use_bytes + nbytes > self.budget_bytes:
                raise ServeCapacityError(
                    f"resident operator needs {nbytes} B but the HBM "
                    f"budget is {self.budget_bytes} B (in use "
                    f"{self.in_use_bytes} B) — the server cannot host "
                    f"the decomposition; raise the budget or shrink "
                    f"the operator")
            self.resident_bytes += nbytes
            self.in_use_bytes += nbytes
            self.peak_in_use_bytes = max(self.peak_in_use_bytes,
                                         self.in_use_bytes)
        self._gauges()

    def reserve(self, nbytes: int) -> bool:
        """Reserve ``nbytes`` if (and only if) they fit the remaining
        headroom; returns whether the reservation was taken."""
        nbytes = max(int(nbytes), 0)
        with self._lock:
            if self.in_use_bytes + nbytes > self.budget_bytes:
                return False
            self.in_use_bytes += nbytes
            self.peak_in_use_bytes = max(self.peak_in_use_bytes,
                                         self.in_use_bytes)
        self._gauges()
        return True

    def swap_resident(self, old_bytes: int, new_bytes: int) -> None:
        """Atomically replace part of the permanent resident charge (a
        grown operator replacing the old one).  Raises :class:`ServeCapacityError` (leaving
        the ledger untouched) when the swap would overrun the budget:
        both operators are briefly live during a migration, but the
        steady state must fit."""
        old_bytes = max(int(old_bytes), 0)
        new_bytes = max(int(new_bytes), 0)
        with self._lock:
            grown = self.in_use_bytes - old_bytes + new_bytes
            if grown > self.budget_bytes:
                raise ServeCapacityError(
                    f"grown resident operator needs {new_bytes} B "
                    f"(replacing {old_bytes} B) but the HBM budget is "
                    f"{self.budget_bytes} B (in use "
                    f"{self.in_use_bytes} B) — refusing to grow past "
                    f"the certificate")
            self.resident_bytes = max(
                self.resident_bytes - old_bytes, 0) + new_bytes
            self.in_use_bytes = max(grown, 0)
            self.peak_in_use_bytes = max(self.peak_in_use_bytes,
                                         self.in_use_bytes)
        self._gauges()

    def release(self, nbytes: int) -> None:
        nbytes = max(int(nbytes), 0)
        with self._lock:
            self.in_use_bytes = max(self.in_use_bytes - nbytes,
                                    self.resident_bytes)
        self._gauges()

    def occupancy(self) -> float:
        if self.budget_bytes <= 0:
            return 1.0 if self.in_use_bytes else 0.0
        return self.in_use_bytes / self.budget_bytes

    def headroom_bytes(self) -> int:
        return max(self.budget_bytes - self.in_use_bytes, 0)

    def snapshot(self) -> dict:
        with self._lock:
            budget = self.budget_bytes
            in_use = self.in_use_bytes
            peak = self.peak_in_use_bytes
            resident = self.resident_bytes
        return {
            "budget_bytes": budget,
            "resident_bytes": resident,
            "in_use_bytes": in_use,
            "peak_in_use_bytes": peak,
            "occupancy": (in_use / budget) if budget > 0 else
                         (1.0 if in_use else 0.0),
            "peak_occupancy": (peak / budget) if budget > 0 else
                              (1.0 if peak else 0.0),
        }


def request_price_bytes(executor, k: int, itemsize: int = 4,
                        repl: int = 1) -> int:
    """Admission price of one request of feature width ``k`` against
    ``executor``: the static model's incremental carriage bytes
    (``obs/memview.request_bytes_for``).  An executor with no model
    prices at 0 with a loud warning — admission control degrades to
    queue-bounding only, it does not guess."""
    from arrow_matrix_tpu_torch.obs.memview import request_bytes_for

    price: Optional[int] = request_bytes_for(executor, k,
                                             itemsize=itemsize,
                                             repl=repl)
    if price is None:
        import sys

        print(f"[graft-serve] WARNING: executor "
              f"{type(executor).__name__} exposes no HBM model; "
              f"admitting width-{k} request unpriced", file=sys.stderr)
        return 0
    return int(price)
