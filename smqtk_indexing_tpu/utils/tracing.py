"""
Tracing / profiling / observability.

The reference's only observability is the ProgressReporter rate logger and
DEBUG log lines (SURVEY.md §5; utils/progress_reporter.py, faiss.py:815-829).
Here, on top of structured logging, the framework exposes:

- ``trace_span(name)``: a context manager emitting both an
  ``jax.profiler.TraceAnnotation`` (visible in device profiler timelines /
  Perfetto) and a wall-clock DEBUG log line. Zero overhead beyond a
  monotonic clock read when profiling is inactive.
- ``start_server(port)`` / ``trace(log_dir)``: thin re-exports of the jax
  profiler entry points so deployments can attach TensorBoard/Perfetto
  without importing jax internals.
- ``Counters``: process-global named counters for recall-critical internals
  (probed lists, candidate pool sizes, merged results), the queryable form
  of the reference's debug-log payloads (mrpt.py:515-523, faiss.py:815-823).
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import jax

LOG = logging.getLogger(__name__)


class Counters:
    """Thread-safe named counters with snapshot/reset semantics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] += value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counts.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


#: Process-global counter registry used by the index implementations.
COUNTERS = Counters()


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Annotate a host-side span for the device profiler + debug logs."""
    t0 = time.monotonic()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.monotonic() - t0
    COUNTERS.add(f"span.{name}.calls")
    COUNTERS.add(f"span.{name}.seconds", dt)
    LOG.debug("span %s: %.6fs", name, dt)


def start_server(port: int = 9999):
    """Start the jax profiler server (attach TensorBoard's profile tab)."""
    return jax.profiler.start_server(port)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
