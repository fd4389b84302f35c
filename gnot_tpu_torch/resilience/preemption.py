"""Graceful preemption: SIGTERM/SIGINT stop the run at the next step boundary.

The port of ``gnot_tpu/resilience/preemption.py``. A preemptible machine
gets SIGTERM and a short grace window; dying mid-step loses everything
since the last periodic checkpoint. The handler only *requests* a stop (a
signal handler must not write checkpoints); the trainer reads the flag at
step boundaries, saves ``latest``, flushes the sink and exits
resume-ready. A second SIGINT raises KeyboardInterrupt at once: "Ctrl-C
twice" stays the emergency exit, ahead of any save.

On a multi-rank run (``should_stop(multiprocess=True)``) every
``sync_every``-th check all-reduces the flag over the ranks
(``parallel/multihost.py::sync_flag``), so a signal that lands on one rank
stops every rank at the same step.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptionHandler:
    """Context manager installing SIGTERM/SIGINT handlers that set a flag
    the training loop reads.

    Signal handlers are process-global and main-thread-only: entered from
    another thread, the handler installs nothing and its flag never fires
    by signal. The previous handlers are restored on exit, so a program
    that calls ``main()`` several times in one process does not leak
    handler state from one run into the next.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, *, sync_every: int = 1):
        self.sync_every = max(1, int(sync_every))
        self._requested = threading.Event()
        self._previous: dict[int, object] = {}
        self._installed = False
        self._sigint_count = 0
        self._checks = 0

    # -- signal side -------------------------------------------------------

    def _handle(self, signum, frame) -> None:
        if signum == signal.SIGINT:
            self._sigint_count += 1
            if self._sigint_count > 1:
                raise KeyboardInterrupt  # second Ctrl-C: bail now
        logger.warning(
            "%s received: stopping at the next step boundary "
            "(checkpoint + metrics flush, then exit resume-ready)",
            signal.Signals(signum).name,
        )
        self._requested.set()

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handle)
            self._installed = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            self._installed = False

    # -- trainer side ------------------------------------------------------

    def request_stop(self) -> None:
        """Programmatic stop request (the same path as the signals)."""
        self._requested.set()

    @property
    def triggered(self) -> bool:
        return self._requested.is_set()

    def should_stop(self, *, multiprocess: bool = False) -> bool:
        """Step-boundary check. One process: the local flag. Several:
        every ``sync_every``-th call all-reduces the flag so all ranks
        agree on the stop step, a COLLECTIVE on those calls (every rank
        calls with the same cadence, which the SPMD loop guarantees); the
        other calls return False without communicating, so a local flag
        waits (bounded) for the next sync point."""
        if not multiprocess:
            return self.triggered
        self._checks += 1
        if self._checks % self.sync_every:
            return False
        from gnot_tpu_torch.parallel import multihost

        return multihost.sync_flag(self.triggered)
