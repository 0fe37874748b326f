"""Low-overhead span tracer for the solve pipeline: the port's copy of
``karpenter_core_tpu/tracing/tracer.py``.

- ``span()`` is a no-op costing one thread-local read when no trace is
  active on the calling thread, so library code can be instrumented
  unconditionally.
- All timestamps come from ``time.perf_counter_ns()`` — one monotonic
  clock for every span, so durations nest exactly (wall time is
  recorded once per trace for correlation only).
- Spans carry a parent reference and accumulate child time, so *self
  time* (duration minus direct children) is exact; the sum of self times
  over a trace's root lane equals the root duration.
- Completed traces land in a fixed-capacity ring buffer (newest-wins,
  ``RING``, ``TRACE_BUFFER`` traces).
- The tracer is thread-local: a worker thread joins a trace only by
  *adopting* an explicit ``TraceContext`` captured where the work was
  enqueued (``capture()``/``adopt()``). Adopted spans land on their own
  thread lane; they never subtract from the capture point's self time.
  Spans born on a thread with no active root and no adopted context are
  *orphans*: they are counted (``orphan_spans()``, exposed as
  ``karpenter_tpu_tracer_orphan_spans_total`` by the metrics registry).

A trace may carry a histogram sink (the solver's
``solver_phase_duration``); every completed span is observed under
``phase=<span name>``. The sink runs even when recording is off
(``TRACE = False``), so the metric surface never depends on it.

The JAX package reads two environment knobs here; the port keeps their
defaults as module constants named for them, which tests monkeypatch:
``TRACE`` (``KARPENTER_TPU_TRACE``, on) and ``TRACE_BUFFER``
(``KARPENTER_TPU_TRACE_BUFFER``, 32 traces, read once at import as the
reference reads it). The slow-trace capture to disk that the
reference's ``trace_root`` calls on every buffered trace is off unless
``KARPENTER_TPU_TRACE_SLOW_MS`` is set, and is not ported: with the
Chrome-trace export, the flight recorder and the device plane it waits
for the tracing slice of the port.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

# synthetic-lane thread id: spans on this lane (e.g. the per-solve
# device_total rollup) are derived quantities, not measured host spans —
# excluded from phase breakdowns, exported on their own named track
SYNTHETIC_TID = -1

_trace_counter = itertools.count(1)

# -- orphan-span accounting ---------------------------------------------------
# A span on a thread with no active trace used to vanish silently; with
# cross-thread context propagation in place that is always an attribution
# bug, so it is counted. The counter is process-global (the metrics
# registry bridges it into karpenter_tpu_tracer_orphan_spans_total) and
# resettable so tests can assert "this scenario orphaned nothing".
_orphan_mu = threading.Lock()
_orphan_total = 0
_orphan_recent: List[str] = []  # last few orphaned span names (debugging)
_ORPHAN_RECENT_KEEP = 16


def _count_orphan(name: str) -> None:
    global _orphan_total
    with _orphan_mu:
        _orphan_total += 1
        _orphan_recent.append(name)
        del _orphan_recent[:-_ORPHAN_RECENT_KEEP]


def orphan_spans() -> int:
    """Spans dropped because no trace was active on their thread."""
    with _orphan_mu:
        return _orphan_total


def orphan_recent() -> List[str]:
    """Names of the most recently orphaned spans (newest last)."""
    with _orphan_mu:
        return list(_orphan_recent)


def reset_orphans() -> None:
    global _orphan_total
    with _orphan_mu:
        _orphan_total = 0
        _orphan_recent.clear()


# span recording (the reference's KARPENTER_TPU_TRACE, default on); read
# per trace, so tests flip it without reimporting
TRACE = True


def enabled() -> bool:
    """Span *recording* switch. The metrics bridge is unaffected — see
    module docstring."""
    return TRACE


class Span:
    """One timed region. ``ts_ns``/``dur_ns`` are perf_counter_ns
    values; ``parent`` is the enclosing Span (None for the root);
    ``child_ns`` accumulates direct children's durations so
    ``self_ns`` needs no interval arithmetic."""

    __slots__ = ("name", "ts_ns", "dur_ns", "tid", "depth", "parent", "child_ns", "args")

    def __init__(self, name: str, ts_ns: int, tid: int, depth: int, parent: Optional["Span"], args: Optional[dict]):
        self.name = name
        self.ts_ns = ts_ns
        self.dur_ns = 0
        self.tid = tid
        self.depth = depth
        self.parent = parent
        self.child_ns = 0
        self.args = args

    @property
    def self_ns(self) -> int:
        return self.dur_ns - self.child_ns

    def __repr__(self) -> str:  # debugging aid only
        return f"Span({self.name!r}, dur={self.dur_ns / 1e6:.3f}ms, depth={self.depth})"


class Trace:
    """One traced operation (normally one solve): a ``trace_id``, the
    completed spans, and optional sinks (metrics histogram)."""

    __slots__ = (
        "trace_id",
        "name",
        "start_ns",
        "end_ns",
        "wall_start",
        "pid",
        "spans",
        "metrics_sink",
        "record",
        "contains_solve",
        "args",
        "root_tid",
        "links",
    )

    def __init__(self, name: str, trace_id: Optional[str] = None, metrics_sink=None, record: bool = True, **args):
        if trace_id is None:
            trace_id = f"t{next(_trace_counter):06d}-{os.getpid():x}"
        self.trace_id = trace_id
        self.name = name
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.wall_start = time.time()
        self.pid = os.getpid()
        self.spans: List[Span] = []
        self.metrics_sink = metrics_sink
        self.record = record
        self.contains_solve = False
        self.args = dict(args)
        # thread the root span runs on: the authoritative lane whose
        # self times partition the root duration. None until trace_root
        # installs the trace (directly-constructed Traces keep the
        # pre-adoption behavior: every lane counts).
        self.root_tid: Optional[int] = None
        # trace_ids of related traces/contexts (e.g. the N tenant solves
        # coalesced into one mega-dispatch) — appended GIL-atomically
        self.links: List[dict] = []

    def add_link(self, trace_id: str, **meta) -> None:
        """Record a relation to another trace (batched work serving many
        decisions, a probe serving a foreign decision, ...)."""
        self.links.append({"trace_id": trace_id, **meta})

    # -- accounting ---------------------------------------------------------

    @property
    def total_ms(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.perf_counter_ns()
        return (end - self.start_ns) / 1e6

    def add_synthetic(self, name: str, ts_ns: int, dur_ns: int, **args) -> Span:
        """A derived span (e.g. accumulated device-attributable time) on
        the synthetic lane — exported, excluded from breakdowns."""
        s = Span(name, ts_ns, SYNTHETIC_TID, 0, None, args or None)
        s.dur_ns = max(int(dur_ns), 0)
        if self.record:
            self.spans.append(s)
        return s

    def phase_breakdown_ms(self) -> Dict[str, float]:
        """Self-time per span name on the ROOT lane, in ms. Synthetic
        spans and adopted foreign-thread lanes are excluded, so the
        values sum to the root span's duration (≈ host + device wall
        time: device waits are real measured spans; concurrent lanes
        overlap the root and would double-count)."""
        out: Dict[str, float] = {}
        root_tid = self.root_tid
        for s in self.spans:
            if s.tid == SYNTHETIC_TID:
                continue
            if root_tid is not None and s.tid != root_tid:
                continue
            out[s.name] = out.get(s.name, 0.0) + s.self_ns / 1e6
        return out

    def lane_breakdown_ms(self) -> Dict[int, Dict[str, float]]:
        """Per-thread-lane self-time breakdowns (the flight recorder's
        concurrent-lane attribution). Keys are thread idents; the root
        lane is present under ``root_tid``; synthetic spans excluded."""
        out: Dict[int, Dict[str, float]] = {}
        for s in self.spans:
            if s.tid == SYNTHETIC_TID:
                continue
            lane = out.setdefault(s.tid, {})
            lane[s.name] = lane.get(s.name, 0.0) + s.self_ns / 1e6
        return out

    def device_ms(self) -> float:
        """Sum of measured device-wait span durations."""
        return sum(s.dur_ns for s in self.spans if s.name == "device_wait") / 1e6


class TraceRing:
    """Fixed-capacity newest-wins buffer of completed traces."""

    def __init__(self, capacity: int = 32):
        self._mu = threading.Lock()
        self._capacity = max(1, int(capacity))
        self._items: List[Trace] = []

    @property
    def capacity(self) -> int:
        with self._mu:
            return self._capacity

    def set_capacity(self, capacity: int) -> None:
        with self._mu:
            self._capacity = max(1, int(capacity))
            del self._items[: -self._capacity]

    def push(self, trace: Trace) -> None:
        with self._mu:
            self._items.append(trace)
            if len(self._items) > self._capacity:
                del self._items[: -self._capacity]

    def last(self) -> Optional[Trace]:
        with self._mu:
            return self._items[-1] if self._items else None

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._mu:
            for t in reversed(self._items):
                if t.trace_id == trace_id:
                    return t
        return None

    def all(self) -> List[Trace]:
        with self._mu:
            return list(self._items)

    def clear(self) -> None:
        with self._mu:
            self._items.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._items)


# completed traces kept (the reference's KARPENTER_TPU_TRACE_BUFFER)
TRACE_BUFFER = 32
RING = TraceRing(TRACE_BUFFER)

_tls = threading.local()

# sentinel trace installed while recording is disabled (TRACE off with no
# metrics sink): inner spans must neither record nor count as
# orphans — the whole subtree is deliberately off, not lost. record=False
# keeps span() from appending to it; the object is shared process-wide and
# never buffered.
_DISABLED = Trace("disabled", trace_id="disabled", record=False)


def current_trace() -> Optional[Trace]:
    tr = getattr(_tls, "trace", None)
    return None if tr is _DISABLED else tr


def current_trace_id() -> Optional[str]:
    tr = getattr(_tls, "trace", None)
    return tr.trace_id if tr is not None and tr is not _DISABLED else None


class TraceContext:
    """An explicit handoff of 'where this work belongs': the active
    trace and the innermost open span at capture time. Immutable — the
    one legal way a trace crosses a thread boundary (queue items, the
    prewarm handshake, fleet lane submissions carry one; the consuming
    thread re-enters the trace with ``adopt``)."""

    __slots__ = ("trace", "parent")

    def __init__(self, trace: Trace, parent: Optional[Span]):
        self.trace = trace
        self.parent = parent

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id

    def __repr__(self) -> str:  # debugging aid only
        return f"TraceContext({self.trace_id!r}, parent={self.parent and self.parent.name!r})"


def capture() -> Optional[TraceContext]:
    """Snapshot the calling thread's active trace + innermost span for
    re-adoption on another thread. None when nothing is being traced
    (the consumer's ``adopt`` then degrades to a no-op)."""
    tr = getattr(_tls, "trace", None)
    if tr is None or tr is _DISABLED:
        return None
    stack: List[Span] = getattr(_tls, "stack", [])
    return TraceContext(tr, stack[-1] if stack else None)


@contextmanager
def adopt(ctx: Optional[TraceContext], name: str, **args):
    """Re-enter a captured trace on the consuming thread.

    The adopted region opens one anchor span (``name``) parented at the
    capture point and runs on this thread's own lane of the shared
    trace; nested ``span()``/``trace_root()`` calls inside join it
    normally. The anchor's duration is NOT added to the capture-point
    parent's child time — the lanes run concurrently, so adopted time
    must not eat the root lane's self time.

    Degrades safely: ``ctx`` None → pass-through (yields None); the
    captured trace already active on this thread → a plain nested span;
    a DIFFERENT trace active here → a span on the active trace carrying
    the foreign trace_id as a link (a thread cannot serve two traces,
    but the relation is recorded on both)."""
    if ctx is None:
        yield None
        return
    tr = getattr(_tls, "trace", None)
    if tr is not None and tr is not _DISABLED:
        if tr is ctx.trace:
            with span(name, **args) as s:
                yield s
            return
        # cross-trace: record the relation both ways, stay on the
        # thread's own trace (batched work serving many decisions)
        tr.add_link(ctx.trace_id, via=name)
        ctx.trace.add_link(tr.trace_id, via=name)
        with span(name, link=ctx.trace_id, **args) as s:
            yield s
        return
    prev = tr  # None or _DISABLED: both restored verbatim on exit
    target = ctx.trace
    anchor = Span(
        name,
        time.perf_counter_ns(),
        threading.get_ident(),
        (ctx.parent.depth + 1) if ctx.parent is not None else 0,
        ctx.parent,
        args or None,
    )
    _tls.trace = target
    _tls.stack = [anchor]
    try:
        yield anchor
    finally:
        anchor.dur_ns = time.perf_counter_ns() - anchor.ts_ns
        # concurrent lane: linked to ctx.parent for tree reconstruction,
        # deliberately absent from its child_ns (see docstring)
        if target.record:
            target.spans.append(anchor)
        sink = target.metrics_sink
        if sink is not None:
            sink.observe(anchor.dur_ns / 1e9, phase=name)
        _tls.trace = prev
        _tls.stack = []


@contextmanager
def span(name: str, **args):
    """Time a region of the active trace. No active trace on this
    thread → pass-through, but counted as an orphan (with context
    propagation in place, a span that vanishes is an attribution bug —
    see module docstring)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        _count_orphan(name)
        yield None
        return
    if tr is _DISABLED:
        yield None
        return
    stack: List[Span] = _tls.stack
    parent = stack[-1] if stack else None
    s = Span(name, time.perf_counter_ns(), threading.get_ident(), len(stack), parent, args or None)
    stack.append(s)
    try:
        yield s
    finally:
        s.dur_ns = time.perf_counter_ns() - s.ts_ns
        stack.pop()
        if parent is not None:
            parent.child_ns += s.dur_ns
        if tr.record:
            tr.spans.append(s)
        sink = tr.metrics_sink
        if sink is not None:
            sink.observe(s.dur_ns / 1e9, phase=name)


@contextmanager
def trace_root(
    name: str,
    metrics_sink=None,
    buffer_if: str = "always",
    is_solve: bool = False,
    **args,
):
    """Open a trace on this thread (or join the active one).

    With an active trace this degrades to a plain ``span`` — the solver
    joins a provisioner-opened trace instead of starting its own — and
    attaches ``metrics_sink`` if the outer trace has none (the
    provisioner opens the trace before it knows which scheduler runs).

    ``buffer_if``: "always" pushes the finished trace to the ring;
    "solve" pushes only when a solve span ran inside it (keeps
    empty provisioner reconciles from evicting real solve traces);
    "never" suppresses buffering (shadow/simulation solves that must
    not displace the live traffic's traces).
    """
    prev = getattr(_tls, "trace", None)
    if prev is not None and prev is not _DISABLED:
        tr = prev
        if metrics_sink is not None and tr.metrics_sink is None:
            tr.metrics_sink = metrics_sink
        if is_solve:
            tr.contains_solve = True
        with span(name, **args):
            yield tr
        return

    record = enabled()
    if not record and metrics_sink is None:
        # nothing to record and nothing to observe: park the disabled
        # sentinel so inner spans are cheap pass-throughs instead of
        # counted orphans (one env read per solve — the disabled mode
        # stays genuinely free)
        _tls.trace = _DISABLED
        _tls.stack = []
        try:
            yield None
        finally:
            _tls.trace = prev
            _tls.stack = []
        return

    tr = Trace(name, metrics_sink=metrics_sink, record=record, **args)
    tr.contains_solve = is_solve
    tr.root_tid = threading.get_ident()
    _tls.trace = tr
    _tls.stack = []
    root = Span(name, tr.start_ns, tr.root_tid, 0, None, args or None)
    _tls.stack.append(root)
    try:
        yield tr
    finally:
        root.dur_ns = time.perf_counter_ns() - root.ts_ns
        tr.end_ns = root.ts_ns + root.dur_ns
        if tr.record:
            tr.spans.append(root)
        sink = tr.metrics_sink
        if sink is not None:
            sink.observe(root.dur_ns / 1e9, phase=name)
        _tls.trace = prev
        _tls.stack = []
        if tr.record and (
            buffer_if == "always" or (buffer_if == "solve" and tr.contains_solve)
        ):
            RING.push(tr)
            from .capture import maybe_capture

            maybe_capture(tr)
