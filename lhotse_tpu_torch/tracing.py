"""
Timing and throughput spans of the host data path (copied from
``lhotse_tpu/tracing.py``): :func:`trace_span` times a named region,
:func:`add_work` attributes work units (audio seconds) to the innermost
span, :func:`tracing_report` sums them and :func:`format_tracing_report`
prints them as a table; :func:`traced` is the decorator form of a span, and
:func:`emit_metrics` pushes the report to the hooks that
:func:`register_metrics_hook` added. Off by default, when a span costs one
boolean check; turn it on with :func:`set_tracing_enabled`.

Spans the ported path records: ``sampler.next`` and ``dataset.assemble``
(the loader), ``collation.read_audio`` and ``audio.decode`` (decode and
collate), and inside ``audio.decode`` the shell pipe of a ``command`` audio
source, ``audio.pipe``.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from functools import wraps
from typing import Any, Dict, Optional

_ENABLED = False
_LOCK = threading.Lock()
_LOCAL = threading.local()


class _SpanStats:
    __slots__ = ("calls", "total_time", "work")

    def __init__(self):
        self.calls = 0
        self.total_time = 0.0
        self.work = 0.0


_STATS: Dict[str, _SpanStats] = defaultdict(_SpanStats)


def set_tracing_enabled(enabled: bool = True) -> None:
    global _ENABLED
    _ENABLED = enabled


def is_tracing_enabled() -> bool:
    return _ENABLED


def reset_tracing() -> None:
    with _LOCK:
        _STATS.clear()


def _stack():
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


@contextmanager
def trace_span(name: str, work: float = 0.0):
    """Time a named region. ``work`` units (e.g. audio seconds) may be given
    upfront or attributed later via :func:`add_work`."""
    if not _ENABLED:
        yield
        return
    stack = _stack()
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        stack.pop()
        with _LOCK:
            s = _STATS[name]
            s.calls += 1
            s.total_time += elapsed
            s.work += work


def traced(name: Optional[str] = None):
    """Decorator form of :func:`trace_span`."""

    def wrap(fn):
        span_name = name or f"{fn.__module__}.{fn.__qualname__}"

        @wraps(fn)
        def inner(*args, **kwargs):
            with trace_span(span_name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def add_work(units: float, name: Optional[str] = None) -> None:
    """Attribute ``units`` of work to span ``name``, or to the innermost
    active span of this thread when ``name`` is omitted. No-op when disabled
    or when there is no active span and no name."""
    if not _ENABLED:
        return
    if name is None:
        stack = _stack()
        if not stack:
            return
        name = stack[-1]
    with _LOCK:
        _STATS[name].work += units


def tracing_report(reset: bool = False) -> Dict[str, Dict[str, Any]]:
    """Per-span summary: calls, total seconds, mean seconds, work units, and
    throughput (work / total seconds)."""
    with _LOCK:
        out = {}
        for name, s in _STATS.items():
            out[name] = {
                "calls": s.calls, "total_s": s.total_time,
                "mean_s": s.total_time / s.calls if s.calls else 0.0, "work": s.work,
                "throughput": s.work / s.total_time if s.total_time > 0 else 0.0}
        if reset:
            _STATS.clear()
    return out


_METRICS_HOOKS = []


def register_metrics_hook(hook) -> None:
    """
    Register a callable receiving the tracing report dict whenever
    :func:`emit_metrics` runs — the thin metrics-export integration point
    (Prometheus pushgateway, W&B, stdout loggers...). Hooks must not raise;
    exceptions are swallowed so an exporter can never take down the data
    pipeline.
    """
    _METRICS_HOOKS.append(hook)


def unregister_metrics_hook(hook) -> None:
    try:
        _METRICS_HOOKS.remove(hook)
    except ValueError:
        pass


def emit_metrics(extra: Optional[Dict[str, Any]] = None, reset: bool = False) -> None:
    """Push the current tracing report (plus optional ``extra`` fields) to
    every registered metrics hook."""
    if not _METRICS_HOOKS:
        return
    payload = tracing_report(reset=reset)
    if extra:
        payload = {**payload, "extra": dict(extra)}
    for hook in list(_METRICS_HOOKS):
        try:
            hook(payload)
        except Exception:
            pass


def format_tracing_report(report: Optional[Dict[str, Dict[str, Any]]] = None) -> str:
    if report is None:
        report = tracing_report()
    if not report:
        return "tracing: no spans recorded (is tracing enabled?)"
    lines = [
        f"{'span':<48} {'calls':>7} {'total s':>10} {'mean ms':>9} "
        f"{'work':>12} {'work/s':>12}"
    ]
    for name in sorted(report, key=lambda n: -report[n]["total_s"]):
        r = report[name]
        lines.append(
            f"{name:<48} {r['calls']:>7} {r['total_s']:>10.3f} "
            f"{r['mean_s'] * 1e3:>9.2f} {r['work']:>12.1f} "
            f"{r['throughput']:>12.1f}"
        )
    return "\n".join(lines)
