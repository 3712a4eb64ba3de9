"""The port's host spans.

``span(name)`` opens a ``torch.profiler`` range (``record_function``), so the
step shows by name in a trace (``call --profile_dir``), and adds its
``perf_counter`` duration to a table of the process, by name, so that a
caller reads what its steps cost without a profiler: ``VariantCaller.run``
puts the spans that ran during the call into ``stage_times`` under their
names.  One span per stage, chunk, batch or contig: with the profiler off a
span costs a few microseconds.

The table belongs to the process because the steps run on threads that no
caller owns (the engines' submitter threads, the extraction pools) and on
engines a caller may reach only through a wrapper.  It only grows, and a
caller reads the difference since it started (``seconds_since``), so what
ran before a call is not in its reading; calls that run at the same time in
one process read each other's spans too.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List

from torch.profiler import record_function

_lock = threading.Lock()
_table: Dict[str, List] = {}  # name -> [seconds, calls], every thread


@contextmanager
def span(name: str):
    with record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _lock:
                entry = _table.setdefault(name, [0.0, 0])
                entry[0] += dt
                entry[1] += 1


def totals() -> Dict[str, tuple]:
    """``{name: (seconds, calls)}`` of every span the process has closed."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _table.items()}


def seconds_since(before: Dict[str, tuple]) -> Dict[str, float]:
    """Seconds of each span closed since ``before = totals()``, on any
    thread; names that did not run are left out."""
    out = {}
    for name, (sec, calls) in totals().items():
        sec0, calls0 = before.get(name, (0.0, 0))
        if calls > calls0:
            out[name] = sec - sec0
    return out
