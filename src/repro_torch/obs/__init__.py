"""``repro_torch.obs`` — span tracing and pipeline counters (counterpart
of ``repro.obs``).

Two primitives, both always importable and free when tracing is off:

- :func:`span` — a context manager (and, via :func:`traced`, a decorator)
  that records one timed region as a JSONL event.  With no trace sink
  installed, ``span(...)`` returns a shared no-op singleton: the call site
  costs one global read and allocates nothing that outlives the
  statement (``tests/test_torch_obs.py`` pins this).
- :func:`count` — a named pipeline counter, always accumulated in-process
  (a handful of integer adds per simulation, not per reference) and
  exported into the trace stream as delta events on :func:`flush`.  Tests
  assert structural invariants on them: "profile scans <= unique
  geometries", "zero simulations on a warm rerun".

Enabling
--------
Tracing turns on when either

- the environment variable :data:`ENV_VAR` (``REPRO_TORCH_TRACE``) names
  a file path at import time (how spawned pool workers inherit the
  parent's sink and merge their spans into one stream), or
- :func:`enable` is called with a path (the ``--trace FILE`` flag of the
  ``repro_torch.suite`` and ``repro_torch.serving`` CLIs does this, and
  exports :data:`ENV_VAR` so child processes follow).

The variable is not the reference's ``REPRO_TRACE``: a process may import
both packages, and each package's sink follows its own variable.

Every event is one JSON object on its own line, written with a single
``write()`` to a file opened in append mode, so concurrent processes
interleave whole lines.  The schema is the reference's: span events carry
``pid``/``tid`` tags, ``ts`` in microseconds since the epoch and ``dur``
in microseconds on ``perf_counter``; counter events carry deltas.  So
``python -m repro.obs report`` reads the port's files and ``python -m
repro_torch.obs report`` reads the reference's.

Reading a trace
---------------
``python -m repro_torch.obs report t.jsonl`` aggregates one or more trace
files into a per-stage wall-clock/counter breakdown; ``python -m
repro_torch.obs chrome t.jsonl -o t.trace.json`` converts to Chrome
trace-event format (loadable in Perfetto).  The counter glossary is in
the README's section on the port.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import sys
import threading
import time

__all__ = [
    "ENV_VAR",
    "enabled",
    "enable",
    "disable",
    "trace_path",
    "span",
    "traced",
    "count",
    "counters",
    "reset_counters",
    "flush",
    "warn_once",
]

ENV_VAR = "REPRO_TORCH_TRACE"


# --------------------------------------------------------------------------
# Sink: one append-mode JSONL stream per process.
# --------------------------------------------------------------------------
class _Sink:
    """Append-mode JSONL event stream (thread-safe, whole-line writes)."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._f = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def write(self, event: dict) -> None:
        line = json.dumps(event, separators=(",", ":")) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


_SINK: _Sink | None = None
_SINK_LOCK = threading.Lock()

_COUNTS: dict[str, float] = {}
_FLUSHED: dict[str, float] = {}
_COUNTS_LOCK = threading.Lock()

_WARNED: set[str] = set()


def enabled() -> bool:
    """Is a trace sink installed?"""
    return _SINK is not None


def trace_path() -> str | None:
    """The active sink's path, or ``None`` when tracing is off."""
    sink = _SINK
    return sink.path if sink is not None else None


def enable(path: str | os.PathLike) -> None:
    """Install a JSONL trace sink at ``path`` (append mode).

    Also exports :data:`ENV_VAR` so child processes — e.g. the suite
    runner's spawn pool workers — open the same file and merge their
    spans into the parent stream.  Idempotent for the same path.
    """
    global _SINK
    with _SINK_LOCK:
        if _SINK is not None:
            if _SINK.path == str(path):
                os.environ[ENV_VAR] = _SINK.path
                return
            _close_sink()
        _SINK = _Sink(str(path))
        os.environ[ENV_VAR] = _SINK.path


def disable() -> None:
    """Flush pending counters, close the sink, stop tracing.

    Clears :data:`ENV_VAR` so later child processes do not resurrect the
    sink.  Counter *accumulation* continues (it is always on); only the
    export stream goes away.
    """
    global _SINK
    with _SINK_LOCK:
        _close_sink()
        os.environ.pop(ENV_VAR, None)


def _close_sink() -> None:
    global _SINK
    if _SINK is not None:
        _flush_locked(_SINK)
        _SINK.close()
        _SINK = None


# --------------------------------------------------------------------------
# Spans
# --------------------------------------------------------------------------
class _NullSpan:
    """Shared no-op span: the entire disabled-path cost of a span site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


class _Span:
    __slots__ = ("_sink", "name", "tags", "_ts_us", "_t0")

    def __init__(self, sink: _Sink, name: str, tags: dict) -> None:
        self._sink = sink
        self.name = name
        self.tags = tags

    def __enter__(self):
        self._ts_us = time.time_ns() // 1000
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur_us = (time.perf_counter() - self._t0) * 1e6
        event = {
            "ev": "span",
            "name": self.name,
            "pid": os.getpid(),
            "tid": threading.get_native_id(),
            "ts": self._ts_us,
            "dur": round(dur_us, 1),
        }
        if self.tags:
            event["tags"] = {k: _jsonable(v) for k, v in self.tags.items()}
        if exc_type is not None:
            event["error"] = exc_type.__name__
        self._sink.write(event)
        return False


def span(name: str, **tags):
    """Timed region context manager: ``with obs.span("profile.scan", ...)``.

    Returns the shared no-op singleton when tracing is off — the site
    pays one global read, and nothing it allocates survives the
    statement.  Tags are JSON-coerced (non-scalar values via ``str``)
    only on the enabled path.
    """
    sink = _SINK
    if sink is None:
        return _NULL_SPAN
    return _Span(sink, name, tags)


def traced(name: str | None = None, **tags):
    """Decorator form of :func:`span`.

    ``@obs.traced("suite.entry")`` (or bare ``@obs.traced()`` to use the
    function's qualname).  The enablement check happens per *call*, not
    at decoration time, so a function decorated at import keeps working
    when tracing is toggled later.
    """

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _SINK is None:
                return fn(*args, **kwargs)
            with span(label, **tags):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# --------------------------------------------------------------------------
# Counters
# --------------------------------------------------------------------------
def count(name: str, n: float = 1) -> None:
    """Add ``n`` to pipeline counter ``name`` (always on, thread-safe)."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, float]:
    """Snapshot of the cumulative in-process counters."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    """Zero all counters and the flush watermark (test isolation)."""
    with _COUNTS_LOCK:
        _COUNTS.clear()
        _FLUSHED.clear()


def flush() -> None:
    """Export counter deltas since the last flush as one trace event.

    No-op when tracing is off.  Deltas (not cumulative values) are
    written so that per-task flushes from pool workers and the parent's
    exit flush sum correctly in the merged stream.
    """
    sink = _SINK
    if sink is not None:
        _flush_locked(sink)


def _flush_locked(sink: _Sink) -> None:
    with _COUNTS_LOCK:
        delta = {
            k: v - _FLUSHED.get(k, 0)
            for k, v in _COUNTS.items()
            if v != _FLUSHED.get(k, 0)
        }
        _FLUSHED.update(_COUNTS)
    if delta:
        sink.write({
            "ev": "counters",
            "pid": os.getpid(),
            "ts": time.time_ns() // 1000,
            "counters": {k: round(v, 6) for k, v in sorted(delta.items())},
        })


def warn_once(key: str, message: str) -> None:
    """One-line stderr warning, once per ``key`` per process.

    Used by skip-and-recompute paths (e.g. a corrupt result-store
    record) so degraded-but-correct behavior is visible without
    spamming; pair with a :func:`count` so the event is also machine
    countable.
    """
    with _COUNTS_LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    print(f"# repro_torch.obs: {message}", file=sys.stderr)


# --------------------------------------------------------------------------
# Import-time init: inherit the parent's sink (spawn-pool workers).
# --------------------------------------------------------------------------
def _init_from_env() -> None:
    path = os.environ.get(ENV_VAR)
    if path:
        try:
            enable(path)
        except OSError as e:  # unwritable path: trace off, run on
            print(f"# repro_torch.obs: cannot open trace file {path!r}: {e}",
                  file=sys.stderr)


@atexit.register
def _at_exit() -> None:
    with _SINK_LOCK:
        _close_sink()


_init_from_env()
