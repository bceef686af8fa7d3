"""The shared retry / backoff / watchdog policy.

The port's copy of ``arrow_matrix_tpu/faults/policy.py`` (stdlib only).
:class:`RetryPolicy` is the one value object the batch CLI's supervised
loop and the server's per-request supervisors share, so the two retry
behaviours cannot drift apart.

Jitter is deterministic and seedable: the ±``jitter`` fraction on each
backoff delay is drawn from a ``random.Random`` seeded by the string
``"{seed}:{salt}:{attempt}"``, which CPython hashes from its bytes, so
two processes, or the two packages, with the same seed sleep the same
schedule bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry / exponential-backoff / watchdog parameters.

    ``delay_s(attempt)`` is the sleep before retry ``attempt`` (1-based
    — the first retry sleeps ``backoff_s``, the next
    ``backoff_s * backoff_factor``, ...), with a deterministic
    ±``jitter`` fraction drawn from ``seed``/``salt``.  ``watchdog_s``
    of 0 disables the per-iteration watchdog.
    """

    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    jitter: float = 0.0          # fraction of the delay, in [0, 1]
    seed: int = 0
    watchdog_s: float = 0.0
    watchdog_grace_s: float = 30.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_s < 0 or self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_s >= 0 and backoff_factor >= 1 required, got "
                f"{self.backoff_s}/{self.backoff_factor}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter is a fraction in [0, 1], got "
                             f"{self.jitter}")

    def delay_s(self, attempt: int, salt: str = "") -> float:
        """Backoff before retry ``attempt`` (1-based), jittered
        deterministically: same (seed, salt, attempt) -> same delay,
        across processes and reruns."""
        a = max(int(attempt), 1)
        base = self.backoff_s * self.backoff_factor ** (a - 1)
        if not self.jitter or not base:
            return base
        u = random.Random(
            f"{self.seed}:{salt}:{a}").uniform(-1.0, 1.0)
        return max(base * (1.0 + self.jitter * u), 0.0)

    def schedule(self, salt: str = "") -> tuple:
        """All ``max_retries`` delays, for logging/tests."""
        return tuple(self.delay_s(a, salt=salt)
                     for a in range(1, self.max_retries + 1))

    def for_worker(self, worker_id: str) -> "RetryPolicy":
        """The same policy re-seeded for one worker: the seed is derived
        from ``(seed, worker_id)`` through sha256 (stable across
        processes, unlike ``hash()``), so N workers retrying the same
        dead dependency draw different jittered schedules while any one
        worker's schedule stays reproducible at a fixed base seed."""
        digest = hashlib.sha256(
            f"{self.seed}:{worker_id}".encode("utf-8")).digest()
        derived = int.from_bytes(digest[:8], "big")
        return dataclasses.replace(self, seed=derived)

    @classmethod
    def from_args(cls, args, **overrides) -> "RetryPolicy":
        """Build from a CLI namespace carrying the ``add_heal_args``
        flags (absent attributes fall back to the defaults)."""
        kw = dict(
            max_retries=int(getattr(args, "max_retries", 2)),
            watchdog_s=float(getattr(args, "watchdog", 0.0) or 0.0),
            jitter=float(getattr(args, "retry_jitter", 0.0) or 0.0),
            seed=int(getattr(args, "seed", 0) or 0),
        )
        kw.update(overrides)
        return cls(**kw)
