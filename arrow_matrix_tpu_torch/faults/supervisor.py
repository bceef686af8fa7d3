"""The self-healing iteration-loop supervisor.

The port's copy of ``arrow_matrix_tpu/faults/supervisor.py``.  The
batch CLI and every server request run their iteration loop through one
:class:`Supervisor`; the loop body stays the caller's, and the
supervisor owns:

  * a per-iteration **watchdog** (``watchdog_s``): the body runs on a
    worker thread, and an iteration past the budget raises
    :class:`WatchdogTimeout` instead of wedging the run;
  * **bounded retry with exponential backoff**: a failed iteration
    re-runs from its entry state; ``max_retries`` consecutive failures
    end the run;
  * a **finite check** on the carried X each iteration
    (:func:`state_is_finite`, one min/max reduction): NaN/Inf rolls
    back to the last checkpoint, or to the iteration's entry state when
    there is none;
  * **checkpoint cadence and resume** through ``utils/checkpoint.py``;
  * **flight-recorder and metrics events** for every fault seen and
    every recovery taken.

On the card a kernel launch returns before the kernel has run.  The
watchdog therefore runs the body and then synchronises the current
stream of the step's device inside the worker thread
(:func:`_settle`), so it times the step and not its enqueue; the worker
thread makes the caller's device current before it starts.

Determinism: recovery re-runs the same step from the same state, so a
recovered run's final X equals a fault-free run's bit for bit.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Optional

import torch

from arrow_matrix_tpu_torch.faults.policy import RetryPolicy
from arrow_matrix_tpu_torch.obs import flight


class Abort(Exception):
    """Unrecoverable, policy-level failure (validation gate, flag
    error): the supervisor never retries it."""


class WatchdogTimeout(RuntimeError):
    """An iteration exceeded the watchdog budget but the stalled
    attempt eventually drained — the iteration is retriable."""


class WatchdogStalled(RuntimeError):
    """An iteration exceeded the watchdog budget and never drained
    within the grace window: a genuine wedge.  In-process retry is
    impossible (the stalled thread cannot be killed); the supervisor
    seals the blackbox and re-raises so process-level recovery
    (checkpoint resume in a fresh process) takes over."""


class NonFiniteState(RuntimeError):
    """The carried X failed the finite-check after an iteration."""


def _leaves(x):
    """The tensors of a carriage: one tensor, or the int8 pair."""
    return x if isinstance(x, tuple) else (x,)


def _finite(t: torch.Tensor) -> bool:
    if not t.is_floating_point() or t.numel() == 0:
        return True
    # One min/max reduction (NaN propagates, +-inf is an extreme): no
    # temporary of the tensor's size, where torch.isfinite(t).all()
    # builds |t| and three boolean masks.
    lo, hi = torch.aminmax(t)
    return bool(torch.isfinite(lo) & torch.isfinite(hi))


def state_is_finite(x) -> bool:
    """True when every element of ``x`` (a tensor, or the int8 pair
    ``(q, scale)``) is finite: one reduction on the tensor's device and
    one scalar read back."""
    return all(_finite(t) for t in _leaves(x))


def _settle(y) -> None:
    """Wait until the kernels that produce ``y`` have run: synchronise
    the current stream of each CUDA tensor's device (nothing to wait
    for on the CPU)."""
    for t in _leaves(y):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()


class Supervisor:
    """Run ``body(x, it) -> y`` for ``it`` in ``[start, stop)`` with
    watchdog / retry / rollback / checkpointing around it.

    ``carry=True`` threads ``y`` into the next iteration's ``x`` (the
    iterated ``X := A @ X`` run); ``carry=False`` keeps ``x`` fixed
    (the fresh-input benchmark loops).  ``layout`` tags checkpoints so
    a resume under a different execution mode fails loudly instead of
    silently permuting rows (utils/checkpoint.py).
    """

    def __init__(self, name: str, *, carry: bool = True,
                 watchdog_s: float = 0.0,
                 watchdog_grace_s: float = 30.0,
                 max_retries: int = 2,
                 backoff_s: float = 0.05,
                 backoff_factor: float = 2.0,
                 policy: Optional[RetryPolicy] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 finite_check: bool = True,
                 layout: Optional[str] = None,
                 registry=None,
                 tracer=None,
                 verbose: bool = True,
                 canonicalize: Optional[Callable[[Any], Any]] = None,
                 mesh=None, mesh_axis: str = "blocks"):
        self.name = name
        #: A mesh of ranks the carriage is sharded over (rows over
        #: ``mesh_axis``): checkpoints are saved and loaded on it
        #: (utils/checkpoint.py), and every attempt's outcome is agreed
        #: over its ranks, so a fault on one rank is a fault on all and
        #: their collectives stay in step.
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.carry = carry
        # The retry/backoff/watchdog knobs live in one shared
        # RetryPolicy (faults/policy.py) so the batch CLI and the
        # server run the identical recovery behavior.  The loose
        # keyword form is kept for existing callers; an explicit
        # ``policy`` wins.
        if policy is None:
            policy = RetryPolicy(
                max_retries=int(max_retries),
                backoff_s=float(backoff_s),
                backoff_factor=float(backoff_factor),
                watchdog_s=float(watchdog_s or 0.0),
                watchdog_grace_s=float(watchdog_grace_s))
        self.policy = policy
        self.watchdog_s = float(policy.watchdog_s or 0.0)
        self.watchdog_grace_s = float(policy.watchdog_grace_s)
        self.max_retries = int(policy.max_retries)
        self.backoff_s = float(policy.backoff_s)
        self.backoff_factor = float(policy.backoff_factor)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.finite_check = finite_check
        self.layout = layout
        self.registry = registry
        self.tracer = tracer
        self.verbose = verbose
        #: Optional map applied to the carried state right before every
        #: save (the JAX package's replicated executors merge their
        #: per-group partial carriages there; the port's single-device
        #: executors carry one whole state and pass none).
        self.canonicalize = canonicalize
        self.faults_seen = 0
        self.recoveries = 0
        self.last_checkpoint_step: Optional[int] = None

    # -- events ------------------------------------------------------------

    def _span(self, name: str, **attrs):
        """A tracer span when the caller attached a tracer, else a
        no-op (the request context is ambient)."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, supervisor=self.name, **attrs)

    def _event(self, kind: str, name: str, **data) -> None:
        flight.record(kind, name, supervisor=self.name, **data)
        if self.registry is not None:
            self.registry.counter(f"heal_{name}",
                                  supervisor=self.name).inc()
        if self.verbose:
            extra = " ".join(f"{k}={v}" for k, v in data.items())
            print(f"[graft-heal {self.name}] {name} {extra}")

    def _fault(self, reason: str, it: int, err: Exception) -> None:
        self.faults_seen += 1
        self._event("fault", reason, iteration=it,
                    error=f"{type(err).__name__}: {err}")

    def _recovery(self, action: str, it: int, **data) -> None:
        self.recoveries += 1
        self._event("heal", action, iteration=it, **data)

    # -- checkpointing -----------------------------------------------------

    def resume(self, like) -> Optional[tuple]:
        """Load the last checkpoint (None when absent/not configured);
        returns ``(x, step)`` restored onto ``like``'s device and dtype.

        Every successful load emits a ``resumed`` flight event carrying
        this supervisor's name (the request/run id) — the checkpoint
        layer's own event has the path but not the identity of the run
        that adopted the state.  A checkpoint predating the version/
        layout tags (pre-canonicalize, "legacy") cannot be verified
        against the current layout: it still loads, but with a LOUD
        warning and ``legacy=True`` on the event, never a crash.
        """
        if not self.checkpoint_path:
            return None
        from arrow_matrix_tpu_torch.utils.checkpoint import (
            checkpoint_meta,
            load_state,
        )

        with self._span("resume", path=self.checkpoint_path):
            meta = checkpoint_meta(self.checkpoint_path)
            state = load_state(self.checkpoint_path, like=like,
                               layout=self.layout, mesh=self.mesh,
                               axis=self.mesh_axis)
        if state is not None:
            self.last_checkpoint_step = state[1]
            legacy = meta is None or int(meta.get("version") or 0) < 1
            if legacy:
                import sys

                print(f"[graft-heal {self.name}] WARNING: checkpoint "
                      f"at {self.checkpoint_path} predates the "
                      f"version/layout tags (legacy format) — the "
                      f"carried-X layout cannot be verified against "
                      f"{self.layout!r}; resuming anyway",
                      file=sys.stderr)
            self._event("heal", "resumed", step=state[1],
                        path=self.checkpoint_path, legacy=legacy)
        return state

    def _save(self, x, step: int) -> None:
        from arrow_matrix_tpu_torch.utils.checkpoint import save_state

        with self._span("checkpoint", step=step):
            if self.canonicalize is not None:
                x = self.canonicalize(x)
            save_state(self.checkpoint_path, x, step,
                       layout=self.layout, mesh=self.mesh,
                       axis=self.mesh_axis)
        self.last_checkpoint_step = step
        self._event("heal", "checkpointed", step=step)

    def _rollback(self, x_entry, it: int, like):
        """State to retry from after a fault at iteration ``it``: the
        last checkpoint when one exists (the NaN-burst contract —
        anything the burst may have touched is discarded), else the
        iteration-entry state."""
        if self.carry and self.checkpoint_path:
            state = self.resume(like)
            if state is not None:
                x_ck, step_ck = state
                if step_ck <= it:
                    self._recovery("rollback_to_checkpoint", it,
                                   resumed_step=step_ck)
                    return x_ck, step_ck
        self._recovery("retry_from_iteration_entry", it)
        return x_entry, it

    # -- the supervised attempt -------------------------------------------

    def _attempt(self, body: Callable, x, it: int):
        if self.watchdog_s <= 0:
            return body(x, it)
        box: dict = {}
        done = threading.Event()
        device = (torch.cuda.current_device()
                  if torch.cuda.is_available() else None)

        def run():
            try:
                if device is not None:
                    torch.cuda.set_device(device)
                y = body(x, it)
                _settle(y)
                box["y"] = y
            except BaseException as e:  # delivered to the caller below
                box["e"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True,
                             name=f"heal-{self.name}-it{it}")
        t.start()
        if not done.wait(self.watchdog_s):
            self._fault("watchdog_timeout", it,
                        WatchdogTimeout(f"iteration {it} exceeded "
                                        f"{self.watchdog_s:.3f}s"))
            # A python thread cannot be killed; give the stall a
            # bounded grace to drain (an injected hang does, a wedged
            # device does not) and retry only when it did.
            if not done.wait(self.watchdog_grace_s):
                raise WatchdogStalled(
                    f"iteration {it} still running after watchdog "
                    f"({self.watchdog_s:.3f}s) + grace "
                    f"({self.watchdog_grace_s:.1f}s); process-level "
                    f"recovery (checkpoint resume) required")
            raise WatchdogTimeout(
                f"iteration {it} exceeded the {self.watchdog_s:.3f}s "
                f"watchdog (drained during grace; retrying)")
        if "e" in box:
            raise box["e"]
        return box["y"]

    # -- the loop ----------------------------------------------------------

    def run(self, body: Callable[[Any, int], Any], x0, start_it: int,
            stop_it: int) -> tuple:
        """Supervised loop; returns ``(x_final, ok)``.

        ``body`` raising :class:`Abort` ends the run immediately with
        ``ok=False`` (policy failures are not retried);
        :class:`WatchdogStalled` is re-raised after sealing the
        blackbox; anything else is a fault: backoff, rollback, retry.
        """
        x = x0
        it = start_it
        consecutive = 0
        while it < stop_it:
            err = None
            try:
                # The attempt span carries iteration + retry ordinal
                # (and, under the server, the ambient request id), so
                # a retried iteration shows up as two attempt spans —
                # the first with an ``error`` arg — on one track.
                with self._span("attempt", iteration=it,
                                retry=consecutive):
                    y = self._attempt(body, x, it)
                    if (self.carry and self.finite_check
                            and not state_is_finite(y)):
                        raise NonFiniteState(
                            f"carried X contains NaN/Inf after "
                            f"iteration {it}")
            except WatchdogStalled as e:
                rec = flight.get_recorder()
                if rec is not None:
                    rec.seal(f"watchdog stalled: {e}")
                raise
            except Exception as e:
                err = e
            err = self._agree(err, it)
            if isinstance(err, Abort):
                self._event("fault", "aborted", iteration=it,
                            error=str(err))
                return x, False
            if err is not None:
                reason = ("nan_detected"
                          if isinstance(err, NonFiniteState) else
                          "watchdog_timeout"
                          if isinstance(err, WatchdogTimeout) else
                          "iteration_error")
                if not isinstance(err, WatchdogTimeout):
                    # watchdog faults were already recorded at expiry
                    # (before the grace join, so a subsequent SIGKILL
                    # still leaves the fault in the blackbox).
                    self._fault(reason, it, err)
                consecutive += 1
                if consecutive > self.max_retries:
                    self._event("fault", "retries_exhausted",
                                iteration=it,
                                retries=self.max_retries)
                    return x, False
                time.sleep(self.policy.delay_s(consecutive,
                                               salt=f"{self.name}:it{it}"))
                x, it = self._rollback(x, it, like=x0)
                continue
            consecutive = 0
            if self.carry:
                x = y
            it += 1
            if (self.carry and self.checkpoint_path
                    and self.checkpoint_every > 0
                    and it % self.checkpoint_every == 0
                    and it < stop_it):
                self._save(x, it)
        if self.carry and self.checkpoint_path and stop_it > start_it:
            # Final-state save: the replay artifact, and the resume
            # point for a longer rerun.
            self._save(x, stop_it)
        return x, True

    def _agree(self, err: Optional[Exception], it: int
               ) -> Optional[Exception]:
        """On a mesh, the attempt's outcome agreed over every rank (the
        worst wins: an abort, then a fault, then success); the rank's
        own ``err`` off a mesh."""
        if self.mesh is None:
            return err
        from arrow_matrix_tpu_torch.parallel import collectives as coll

        mine = 0 if err is None else 2 if isinstance(err, Abort) else 1
        worst = coll.all_reduce_max(mine, self.mesh, None)
        if worst == mine:
            return err
        if worst == 2:
            return Abort(f"iteration {it} aborted on another rank of "
                         f"the mesh")
        return RuntimeError(f"iteration {it} failed on another rank of "
                            f"the mesh")

    def summary(self) -> dict:
        return {"supervisor": self.name, "faults_seen": self.faults_seen,
                "recoveries": self.recoveries,
                "last_checkpoint_step": self.last_checkpoint_step}
