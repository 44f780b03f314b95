"""Span tracer with async-launch-aware timing and a Chrome/Perfetto exporter.

**Why dispatch/harvest split timing.**  A CUDA launch returns to the host
microseconds after *enqueueing* the work on the current stream; the device
finishes later, and the only honest completion timestamp the host can
observe is when something blocks on the result (an event ``synchronize``
or a device-to-host copy at harvest).  Timing a launch
as ``t_after_call - t_before_call`` therefore measures queue insertion, not
inference, and timing it with a blocking call inside the loop destroys the
pipelining being measured.  The tracer's answer is *two kinds of spans*:

* **sync spans** (``with tracer.span(...)``): classic nested host-side
  regions, parented by the enclosing open span (a thread-local-free explicit
  stack -- the driver is single-threaded by design).
* **async spans** (``tracer.begin(...)`` / ``tracer.end(id)``): opened at
  dispatch, closed at harvest, on their own track.  Overlapping async spans
  in the exported trace ARE the pipeline: five in-flight launches render as
  five staggered bars, and the gap the host spends blocked shows up as the
  tail of the last one.  Nothing pretends device work finished before
  something observed that it did.

Spans are plain records (name, track, interval, parent id, attrs); export is
the Chrome trace event format (the JSON flavour Perfetto and
``chrome://tracing`` both load): one ``"X"`` complete event per finished
span, ``"i"`` instants for point events, and ``"M"`` metadata naming each
track.  ``Tracer(annotate=True)`` additionally wraps sync spans in
``torch.profiler.record_function`` so the same region names land inside a
``torch.profiler`` trace when one is being captured; the import is lazy and
failure degrades to plain spans (the obs layer itself never requires torch).
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_CURRENT = object()  # default parent sentinel: "whatever span is open"


@dataclasses.dataclass
class Span:
    """One traced region.  ``t_end is None`` while still open."""

    name: str
    span_id: int
    parent_id: Optional[int]
    track: str
    t_start: float
    t_end: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    instant: bool = False

    @property
    def done(self) -> bool:
        return self.t_end is not None

    @property
    def dur_ms(self) -> float:
        if self.t_end is None:
            raise ValueError(f"span {self.name!r} still open")
        return (self.t_end - self.t_start) * 1e3


class Tracer:
    """Collects spans; off-path cost is one ``is None`` check at call sites.

    All instrumented layers take ``trace=None`` and skip every tracer touch
    when unset, so the traced and untraced programs execute the same device
    work -- bit-identity is structural, and the overhead bound is a
    regression-tested property of the *enabled* tracer.
    """

    def __init__(self, clock=time.perf_counter, annotate: bool = False):
        self._clock = clock
        self._spans: List[Span] = []
        self._stack: List[int] = []
        self._annotate = annotate
        self._annotation_cls = None  # resolved lazily on first sync span

    # -------------------------------------------------------------- recording
    def begin(
        self,
        name: str,
        parent=_CURRENT,
        track: str = "host",
        **attrs,
    ) -> int:
        """Open a span now and return its id (caller must :meth:`end` it).

        The async half of the dispatch/harvest split: the driver calls this
        at dispatch and ``end`` at harvest.  ``parent`` defaults to the
        innermost open *sync* span; pass ``parent=None`` for a root span or
        an explicit id to nest under a specific one (retry spans nest under
        the launch that flagged their frame).
        """
        pid = self._stack[-1] if parent is _CURRENT and self._stack else parent
        sp = Span(
            name=name,
            span_id=len(self._spans),
            parent_id=None if pid is _CURRENT else pid,
            track=track,
            t_start=self._clock(),
            attrs=attrs,   # **attrs is already a fresh dict; no copy needed
        )
        self._spans.append(sp)
        return sp.span_id

    def end(self, span_id: int, **attrs) -> Span:
        """Close an async span; extra attrs merge into the record."""
        sp = self._spans[span_id]
        if sp.t_end is not None:
            raise ValueError(f"span {sp.name!r} (id {span_id}) already ended")
        sp.t_end = self._clock()
        sp.attrs.update(attrs)
        return sp

    @contextmanager
    def span(self, name: str, parent=_CURRENT, track: str = "host", **attrs):
        """Nested sync span: parented by the enclosing open span."""
        sid = self.begin(name, parent=parent, track=track, **attrs)
        self._stack.append(sid)
        annotation = self._resolve_annotation(name)
        try:
            if annotation is not None:
                with annotation:
                    yield self._spans[sid]
            else:
                yield self._spans[sid]
        finally:
            self._stack.pop()
            self.end(sid)

    def event(self, name: str, track: str = "host", **attrs) -> int:
        """Zero-duration instant event (a ``ph: "i"`` mark in the export)."""
        sid = self.begin(name, track=track, **attrs)
        sp = self._spans[sid]
        sp.t_end = sp.t_start
        sp.instant = True
        return sid

    def _resolve_annotation(self, name: str):
        if not self._annotate:
            return None
        if self._annotation_cls is None:
            try:
                from torch.profiler import record_function

                self._annotation_cls = record_function
            except Exception:  # torch absent or too old: degrade silently
                self._annotate = False
                return None
        return self._annotation_cls(name)

    # -------------------------------------------------------------- querying
    @property
    def spans(self) -> List[Span]:
        """All spans in begin order (open ones included)."""
        return list(self._spans)

    @property
    def open_spans(self) -> List[Span]:
        return [s for s in self._spans if not s.done]

    def named(self, prefix: str) -> List[Span]:
        """Spans whose name starts with ``prefix``, in begin order."""
        return [s for s in self._spans if s.name.startswith(prefix)]

    def get(self, span_id: int) -> Span:
        return self._spans[span_id]

    def span_counts(self) -> Dict[str, int]:
        """Multiset of span names -- the async-vs-sync equality invariant:
        a sync and an async drain of the same workload must traverse the
        same launches/harvests, only on a different wall-clock schedule."""
        out: Dict[str, int] = {}
        for s in self._spans:
            out[s.name] = out.get(s.name, 0) + 1
        return out

    # ------------------------------------------------------------- exporting
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace event JSON (loadable by Perfetto / chrome://tracing).

        Tracks map to tids; timestamps are microseconds relative to the
        earliest span so traces from different processes line up at 0.
        """
        tracks: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        t0 = min((s.t_start for s in self._spans), default=0.0)
        for s in self._spans:
            tid = tracks.setdefault(s.track, len(tracks) + 1)
            args = {k: _jsonable(v) for k, v in s.attrs.items()}
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            ev: Dict[str, Any] = {
                "name": s.name,
                "pid": 1,
                "tid": tid,
                "ts": (s.t_start - t0) * 1e6,
                "args": args,
            }
            if s.instant:
                ev.update(ph="i", s="t")
            else:
                # still-open spans export as zero-length with a marker attr
                # rather than vanishing from the artifact
                end = s.t_end if s.t_end is not None else s.t_start
                ev.update(ph="X", dur=(end - s.t_start) * 1e6)
                if s.t_end is None:
                    args["unfinished"] = True
            events.append(ev)
        meta = [
            {
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": track},
            }
            for track, tid in sorted(tracks.items(), key=lambda kv: kv[1])
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write :meth:`to_chrome_trace` JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def _jsonable(v):
    """Span attrs may carry numpy scalars etc.; coerce to JSON-safe types."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    try:
        return v.item()  # numpy / torch scalar
    except AttributeError:
        return repr(v)
