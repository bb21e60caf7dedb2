"""Failure handling: restart-from-checkpoint, fault injection and the
stall watchdog — the port's own copy of ``theanompi_tpu.runtime.fault``
(whose code imports no jax, but whose package ``__init__`` does).

- ``run_with_restart``: drive a training callable; on a crash, call it
  again (the callable resumes from its latest checkpoint —
  ``BSP_Worker``'s ``resume=True`` path; ``launch.py --restarts``).
- ``FaultInjector``: a deterministic fault plan (raise, kill, hang or
  slow at iteration K on rank R), also read from
  ``THEANOMPI_FAULT_PLAN``.
- ``Watchdog``: fires when no iteration completes within a timeout;
  dumps every thread's stack and, with ``action='exit'``, ends the
  process with code 86 so that a supervisor restarts it.

Behaviour, names and exit codes are the reference's
(``tests/test_torch_fault.py`` holds the two side by side).
"""

from __future__ import annotations

import contextlib
import time
import traceback
from typing import Callable, Optional


class TrainingFault(RuntimeError):
    """Injected fault (distinguishable from real bugs in tests)."""


class FaultInjector:
    """Deterministic fault plan fired at (rank, iteration) points.

    Plan entries are ``(rank, iteration)`` (back-compat: mode
    ``'raise'``) or ``(rank, iteration, mode[, arg])`` with mode one of:

    - ``'raise'`` — raise :class:`TrainingFault` (a crash the worker's
      own exception handling sees; restart-from-checkpoint territory).
    - ``'kill'``  — ``os._exit(KILL_EXIT_CODE)``: the process dies with
      no Python-level cleanup, the closest in-process stand-in for a
      preemption/SIGKILL.  The elastic membership drill's weapon: the
      server/peers must EVICT the rank and a respawn must RE-ADMIT it.
    - ``'hang'``  — block this iteration for ``arg`` seconds (default
      3600): the failure crashes can't model; only the stall watchdog
      or heartbeat eviction sees it.
    - ``'slow'``  — from this iteration ON, sleep ``arg`` seconds
      (default 0.05) every iteration: a persistent straggler, the
      signal adaptive τ / gossip peer bias react to.

    Each entry fires once; ``'slow'`` stays latched after firing.
    """

    KILL_EXIT_CODE = 77  # distinct from crashes AND the watchdog's 86

    MODES = ("raise", "kill", "hang", "slow")

    def __init__(self, plan):
        self._plan = {}
        for p in plan:
            p = tuple(p)
            rank, iteration = int(p[0]), int(p[1])
            mode = str(p[2]) if len(p) > 2 else "raise"
            if mode not in self.MODES:
                raise ValueError(
                    f"fault mode must be one of {self.MODES}, got {mode!r}"
                )
            arg = float(p[3]) if len(p) > 3 else None
            self._plan[(rank, iteration)] = (mode, arg)
        self._slow: dict = {}  # rank -> per-iteration delay, latched

    @classmethod
    def from_env(cls, rank=None, env=None) -> "FaultInjector | None":
        """``THEANOMPI_FAULT_PLAN="kill@1:40;slow@2:10:0.05"`` — the
        spelling the elastic supervisor hands spawned processes (one
        ``mode@rank:iter[:arg]`` per ``;``).  ``rank`` filters the plan
        to entries for this process; returns None when nothing applies
        (the hot loop then skips the injector entirely)."""
        import os as _os

        spec = ((env or _os.environ).get("THEANOMPI_FAULT_PLAN") or "").strip()
        if not spec:
            return None
        plan = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                mode, _, rest = part.partition("@")
                fields = rest.split(":")
                r, it = int(fields[0]), int(fields[1])
                entry = [r, it, mode.strip()]
                if len(fields) > 2:
                    entry.append(float(fields[2]))
            except (ValueError, IndexError):
                raise ValueError(
                    f"THEANOMPI_FAULT_PLAN: cannot parse {part!r} "
                    "(want mode@rank:iter[:arg])"
                )
            if rank is None or r == int(rank):
                plan.append(entry)
        return cls(plan) if plan else None

    def maybe_fail(self, rank: int, iteration: int) -> None:
        delay = self._slow.get(rank)
        if delay:
            time.sleep(delay)
        key = (int(rank), int(iteration))
        entry = self._plan.pop(key, None)
        if entry is None:
            return
        mode, arg = entry
        if mode == "raise":
            raise TrainingFault(
                f"injected fault at rank={rank} iter={iteration}"
            )
        if mode == "kill":
            import os as _os
            import sys as _sys

            print(
                f"FAULT: killing rank {rank} at iter {iteration} "
                f"(exit {self.KILL_EXIT_CODE})",
                file=_sys.stderr, flush=True,
            )
            _sys.stderr.flush()
            _os._exit(self.KILL_EXIT_CODE)
        if mode == "hang":
            time.sleep(3600.0 if arg is None else arg)
            return
        # slow: latch the per-iteration delay from here on
        self._slow[int(rank)] = 0.05 if arg is None else arg


class Watchdog:
    """Stall detector for training loops — the failure mode crash
    handling can't see.

    A crashed worker raises and ``run_with_restart`` recovers; a HUNG
    worker (a deadlocked collective, a wedged device, stuck host IO)
    raises nothing and stalls the job forever.

    The loop calls ``tick()`` once per iteration; a daemon thread fires
    when no tick lands within ``timeout_s``:

    - dumps every thread's stack via ``faulthandler`` (the diagnostic —
      where the hang is),
    - calls ``on_stall`` if given (log/alert hooks),
    - and with ``action='exit'`` terminates the PROCESS via
      ``os._exit(EXIT_CODE)``. A Python-level exception cannot preempt
      a thread blocked in a C call (the hang case by definition), so
      in-process recovery is impossible by construction; exit is the
      honest action, and a supervisor — ``launch.py --spawn-procs``'s
      parent, or ``run_with_restart`` around a spawned group — sees the
      death and restarts from the latest checkpoint. The default
      ``action='dump'`` only diagnoses.
    """

    EXIT_CODE = 86  # distinguishable from crashes in supervisor logs

    @classmethod
    def maybe(cls, timeout_s, action: str = "dump", **kw):
        """THE optional-watchdog constructor every integration uses:
        ``None`` for a falsy timeout, else an armed-on-first-tick
        watchdog — one site for the deferral semantics instead of a
        copy at every worker and supervisor."""
        if not timeout_s:
            return None
        kw.setdefault("arm_on_first_tick", True)
        return cls(float(timeout_s), action=action, **kw)

    @classmethod
    def validate_action(cls, action: str) -> str:
        """THE action check — every constructor that forwards an action
        here calls this so misconfiguration fails early and the error
        text can't drift across call sites."""
        if action not in ("dump", "exit"):
            raise ValueError(
                f"watchdog action must be 'dump' or 'exit', got {action!r}"
            )
        return action

    def __init__(
        self,
        timeout_s: float,
        action: str = "dump",
        on_stall: Optional[Callable[[float], None]] = None,
        poll_s: Optional[float] = None,
        arm_on_first_tick: bool = False,
    ):
        self.validate_action(action)
        import threading

        self.timeout_s = float(timeout_s)
        self.action = action
        self.on_stall = on_stall
        self._poll_s = poll_s if poll_s is not None else min(5.0, timeout_s / 4)
        self._last = time.monotonic()
        self._fired = False
        self._paused = 0
        # arm_on_first_tick: detection starts only once the loop proves
        # it's alive — arbitrarily long startup (per-thread compiles)
        # can never count as a stall
        self._armed = not arm_on_first_tick
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, name="watchdog", daemon=True
        )
        self._thread.start()

    def tick(self) -> None:
        # _last BEFORE _armed: the watcher must never observe the armed
        # state paired with a stale timestamp (a preemption between the
        # two writes in the other order could false-fire on first tick)
        self._last = time.monotonic()
        self._armed = True

    @contextlib.contextmanager
    def pause(self):
        """Context manager suspending stall detection across a phase
        that legitimately exceeds the tick cadence (full validation,
        big checkpoint write): a post-hoc tick can't retract a firing
        that already happened mid-phase."""
        self._paused += 1
        try:
            yield
        finally:
            # rearm fresh BEFORE unpausing — same ordering hazard as
            # tick(): unpaused + stale _last would false-fire
            self._last = time.monotonic()
            self._paused -= 1

    def _watch(self) -> None:
        import faulthandler
        import os
        import sys

        while not self._stop.wait(self._poll_s):
            if self._paused or not self._armed:
                continue
            idle = time.monotonic() - self._last
            if idle < self.timeout_s:
                continue
            self._fired = True
            print(
                f"WATCHDOG: no progress tick for {idle:.0f}s "
                f"(timeout {self.timeout_s:.0f}s) — thread stacks follow",
                file=sys.stderr,
                flush=True,
            )
            faulthandler.dump_traceback(file=sys.stderr)
            if self.on_stall is not None:
                try:
                    self.on_stall(idle)
                except Exception:
                    pass  # a broken hook must not mask the stall report
            if self.action == "exit":
                os._exit(self.EXIT_CODE)
            self._last = time.monotonic()  # dump mode: rearm, keep watching

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_with_restart(
    run_fn: Callable[[int], None],
    max_restarts: int = 3,
    backoff_s: float = 0.0,
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
) -> int:
    """Call ``run_fn(attempt)`` until it completes; restart on exceptions.

    Returns the number of restarts consumed. Re-raises once the budget is
    exhausted.  ``run_fn`` must be restartable (resume from checkpoints).
    """
    attempt = 0
    while True:
        try:
            run_fn(attempt)
            return attempt
        except (KeyboardInterrupt, SystemExit):
            raise  # operator abort is not a fault — never restart on it
        except Exception as e:
            attempt += 1
            if on_failure is not None:
                on_failure(attempt, e)
            if attempt > max_restarts:
                raise
            traceback.print_exc()
            print(f"restart {attempt}/{max_restarts} after: {e!r}", flush=True)
            if backoff_s:
                time.sleep(backoff_s)
