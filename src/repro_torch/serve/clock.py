"""Injectable time source for the serving front end.

A copy of ``repro/serve/clock.py``: the port imports nothing of ``repro``.

Every time-dependent serving behavior — micro-batch deadlines, request
expiry, degradation windows — reads time and performs timed waits through
a ``Clock`` so tests can drive the whole front end deterministically with
``FakeClock``: no ``time.sleep``, no flaky "waited long enough?" asserts.

The contract is deliberately tiny:

  * ``now()``            — monotonic seconds (origin arbitrary);
  * ``wait_on(cond, t)`` — park on an already-held ``threading.Condition``
                           until notified or ``t`` seconds pass
                           (``t=None`` = wait for a notify only).

Producers wake consumers with plain ``cond.notify_all()`` — the clock only
mediates how *timeouts* elapse. Under ``SystemClock`` a timed wait is just
``Condition.wait(timeout)``. Under ``FakeClock`` virtual time is frozen
until the test calls ``advance(dt)``, which wakes exactly the waiters
whose deadlines have come due; ``wait_for_waiters(n)`` lets the test rank
with a worker thread (block until it is parked) before advancing, so the
interleaving is pinned, not raced. ``wait_for_waiters`` is the one place
real time appears — as a guard against a deadlocked test, never as an
assertion.

Timed-wait call sites must loop: a wait can return early (a producer
notify meant for another consumer, or an advance() that only partially
covers the timeout), so correctness always comes from re-checking the
predicate and the remaining budget against ``now()``, exactly like a
plain condition variable.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Time-source protocol (see module docstring)."""

    def now(self) -> float:
        raise NotImplementedError

    def wait_on(self, cond: "threading.Condition",
                timeout: float | None) -> None:
        """Park on ``cond`` (held by the caller) until notified or
        ``timeout`` virtual seconds elapse. May return early — callers
        re-check their predicate against ``now()``."""
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        """Block the calling thread for ``dt`` (virtual) seconds."""
        cond = threading.Condition()
        deadline = self.now() + dt
        with cond:
            while True:
                remaining = deadline - self.now()
                if remaining <= 0:
                    return
                self.wait_on(cond, remaining)


class SystemClock(Clock):
    """Real wall-clock time — the production default."""

    def now(self) -> float:
        return time.monotonic()

    def wait_on(self, cond, timeout):
        cond.wait(timeout=None if timeout is None else max(timeout, 0.0))

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class FakeClock(Clock):
    """Virtual time for deterministic tests.

    ``now()`` is frozen until ``advance(dt)`` moves it; timed waiters
    park for real (their thread blocks) but their timeout elapses only
    in virtual time. The test choreography is always:

        fake.wait_for_waiters(1)   # worker is parked on its timeout
        fake.advance(wait_s)       # its deadline comes due -> it wakes

    Waiters with ``timeout=None`` park untimed (woken only by producer
    notifies) and do **not** count toward ``wait_for_waiters`` — they are
    idle consumers, not pending timeouts.
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)
        self._lock = threading.Lock()
        # parked timed waiters: id -> (cond, virtual deadline)
        self._waiters: dict[int, tuple[threading.Condition, float]] = {}
        self._next_id = 0
        self._parked = threading.Condition(self._lock)

    def now(self) -> float:
        with self._lock:
            return self._t

    def wait_on(self, cond, timeout):
        if timeout is None:
            cond.wait()                     # producer notify only
            return
        if timeout <= 0:
            return
        with self._lock:
            wid = self._next_id
            self._next_id += 1
            self._waiters[wid] = (cond, self._t + timeout)
            self._parked.notify_all()
        try:
            cond.wait()
        finally:
            with self._lock:
                self._waiters.pop(wid, None)

    def advance(self, dt: float) -> None:
        """Move virtual time forward and wake every timed waiter whose
        deadline has come due."""
        if dt < 0:
            raise ValueError(f"cannot advance by {dt}")
        with self._lock:
            self._t += dt
            due = [c for c, dl in self._waiters.values() if dl <= self._t]
        for cond in due:
            with cond:
                cond.notify_all()

    def n_waiters(self) -> int:
        """Timed waiters currently parked."""
        with self._lock:
            return len(self._waiters)

    def wait_for_waiters(self, n: int = 1, timeout: float = 10.0) -> None:
        """Block (real time, bounded) until >= ``n`` timed waiters are
        parked. This is synchronization, not a timing assertion: it
        returns the moment the condition holds, and the real-time bound
        only guards against a deadlocked test.
        """
        deadline = time.monotonic() + timeout
        with self._lock:
            while len(self._waiters) < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"only {len(self._waiters)} timed waiter(s) "
                        f"parked after {timeout}s (wanted {n})")
                self._parked.wait(timeout=remaining)
