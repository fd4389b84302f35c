"""Graceful preemption: SIGTERM/SIGINT stop the run at the next step boundary.

The port of ``gnot_tpu/resilience/preemption.py``. A preemptible machine
gets SIGTERM and a short grace window; dying mid-step loses everything
since the last periodic checkpoint. The handler only *requests* a stop (a
signal handler must not write checkpoints); the trainer reads the flag at
step boundaries, saves ``latest``, flushes the sink and exits
resume-ready. A second SIGINT raises KeyboardInterrupt at once: "Ctrl-C
twice" stays the emergency exit, ahead of any save.

Only single-process runs are ported: the multi-host agreement on the stop
step (``should_stop(multiprocess=True)``, an allgathered flag every
``sync_every`` checks) waits for the port's multi-process training
(``ROADMAP.md``) and raises ``NotPortedError``. Stdlib only, but for that
error.
"""

from __future__ import annotations

import logging
import signal
import threading

from gnot_tpu_torch.config import NotPortedError

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
        """The step-boundary check: the local flag, which is what a
        single-process JAX run reads whatever ``sync_every`` is."""
        if multiprocess:
            raise NotPortedError(
                "the multi-host stop agreement (gnot_tpu/resilience/"
                "preemption.py, multihost.sync_flag) is not ported: the "
                "port trains in one process"
            )
        return self.triggered
