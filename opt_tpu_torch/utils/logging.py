"""Verbosity-gated solver logging (reference: logSolver, o.t:31-78;
verbosity levels documented at Opt.h:16-20).

Level 0: silent. 1 and up: solver progress (cost per nonlinear iteration)
and bind-time notices (clamped ±inf sentinels), on stderr, and the C API's
one line a finished solve (``native_bridge``), on stdout. 3: debug (the
plan report, written once a plan by ``Plan.solve``).
"""

from __future__ import annotations

import sys

_VERBOSITY = 0


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = int(level)


def verbosity() -> int:
    return _VERBOSITY


def log_solver(msg: str, *args) -> None:
    if _VERBOSITY >= 1:
        print(msg % args if args else msg, file=sys.stderr)


def log_result(msg: str) -> None:
    """A result line a caller reads back, on stdout (flushed: a C client's
    own output shares the stream)."""
    if _VERBOSITY >= 1:
        print(msg, flush=True)


def log_debug(msg: str, *args) -> None:
    if _VERBOSITY >= 3:
        print(msg % args if args else msg, file=sys.stderr)
