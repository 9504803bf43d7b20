"""SIGTERM as a normal interpreter exit (the port's copy of
incubator_predictionio_tpu/utils/lease.py).

A process killed by SIGTERM's default action dies with no interpreter
shutdown: no ``finally`` blocks, no atexit, no destructors. The CLI's
server verbs hold a CUDA context, a bound socket and an open SQLite store;
:func:`install_sigterm_exit` converts SIGTERM into ``SystemExit`` so that
``timeout``, supervisors and ``kill`` tear the process down through the
interpreter: the servers stop, the store closes and the card is released
cleanly. The handler runs between bytecodes, so a kernel launch or a
storage write in progress returns first and then the exit proceeds.
"""

from __future__ import annotations

import signal
import sys
import threading


def install_sigterm_exit(code: int = 143) -> bool:
    """Install a SIGTERM → ``SystemExit(code)`` handler (main thread
    only; signal handlers cannot be installed elsewhere). Returns True
    when installed. Idempotent; never raises."""
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        def _exit(_signum, _frame):
            # raising (not os._exit) unwinds through finally blocks and
            # atexit, closing the servers and the store cleanly
            raise SystemExit(code)

        signal.signal(signal.SIGTERM, _exit)
        return True
    except (ValueError, OSError):  # non-main interpreter contexts
        return False


def _selftest() -> None:  # pragma: no cover - manual aid
    install_sigterm_exit()
    signal.raise_signal(signal.SIGTERM)


if __name__ == "__main__":  # pragma: no cover
    _selftest()
    sys.exit(1)  # unreachable if the handler worked
