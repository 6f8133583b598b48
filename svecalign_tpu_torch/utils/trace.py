"""The port's one tracer: spans and counters, on the profiler's clock.

A span is a named stretch of one thread's host time: its start and end
(``perf_counter_ns``, moved onto the wall clock that ``torch.profiler``
stamps its events with by one offset taken when tracing turns on), its
parent (the span open on the same thread when it began), a request id
(the unit of work it belongs to, inherited from its parent unless given)
and its self time (its duration less its children's). Spans live in this
module's memory only: no span enters the profiler's event list (no
``record_function``, no NVTX), so a profiled window counts only the
device's kernels, copies and sets as work, and the two can be laid side
by side by their timestamps.

A span given a device also records a timing event on that device's
current stream at its entry and at its exit. The events are resolved at
:func:`flush`, never waited on: the stages call it where they wait for
the card anyway (stage 5.3 after a document's pull, stage 5.4 after a
bucket's results), and the readers of :func:`totals` and :func:`spans`
resolve what has completed. Each device's event times are put on the
host clock by one anchor event, recorded and waited for when the device
gets its first event after tracing turned on (at a stage's entry, before
it queues any work): the tracer's only wait. A device span has

- ``device_s``: exit event less entry event, the time the card spent on
  the span's queued work, gaps inside it included;
- for a span marked ``host_only`` (it queues nothing on its device),
  ``device_idle_s``: ``max(0, end - max(start, entry event's
  completion))``, the seconds the card's queue sat empty while the host
  did this span's work.

No span records an event while a stream is capturing a CUDA graph, nor
inside :func:`holding` (a graph's warm-up and capture): a span opened
there does nothing.

Areas, each with its switch (an environment variable read at the area's
entry, :meth:`Area.switch`); an area's spans record only while it is on:

- ``EMBED`` (``SVECALIGN_EMBED_PROFILE``): the encoders' span loop of
  stages 5.3 and 6.5, the mesh's issue, the stage-5.3 CLI;
- ``ALIGN`` (``SVECALIGN_ALIGN_PROFILE``): stage 5.4 and the batched
  pyramid;
- ``SEARCH`` (``SVECALIGN_SEARCH_PROFILE``): the kNN search and stages
  6.6 and 6.7;
- ``VAD`` (``SVECALIGN_VAD_PROFILE``): the Silero VAD of stage 4.1;
- ``UNTRANS`` (``SVECALIGN_UNTRANS_PROFILE``): stages 4.2 and 6.2;
- ``TRAIN`` (``SVECALIGN_TRAIN_PROFILE``): the trainer's steps;
- ``PIPELINE`` (on while any of the six is "1"): the pipeline's stages;
- ``ASR`` (``SVECALIGN_ASR_PROFILE``): the audit stage's transcription,
  Whisper's (``analysis/asr.py``) and Parakeet-TDT's (``analysis/tdt.py``).

While an area is off a span costs one boolean test: no event, no
allocation, no synchronise.

Counters (:func:`count`) are kept two ways: :data:`counts` over the
process's life (the byte dicts of ``vecalign/batch.py`` read them), and
the counts made while any area is on (:func:`traced_counts`).

Totals by span name are always kept; the finished spans themselves up
to :data:`MAX_SPANS`, until :func:`reset`.
"""

import contextlib
import itertools
import os
import threading
import time
from collections import Counter
from collections.abc import Mapping
from typing import Dict, List, Optional

import torch

MAX_SPANS = 200_000
MAX_PENDING = 4096  # spans with unresolved events before a span's end flushes

counts: Counter = Counter()
"""Every :func:`count` since the process started (or :func:`reset`)."""


class CudaEvents:
    """``torch.cuda.Event`` behind the interface the tracer uses (a test
    puts a stand-in with the same methods in :data:`event_type`, which
    then serves every device):

    - ``record(device)``: a timing event recorded on the device's
      current stream;
    - ``anchor(device)``: ``(event, host_ns)``, an event recorded, waited
      for, and the host's ``perf_counter_ns`` just after;
    - ``done(event)``: whether the event has completed (no wait);
    - ``ms(a, b)``: milliseconds from event ``a`` to event ``b``;
    - ``capturing(device)``: whether the current stream is capturing.
    """

    @staticmethod
    def record(device: torch.device):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    @staticmethod
    def anchor(device: torch.device):
        ev = CudaEvents.record(device)
        ev.synchronize()
        return ev, time.perf_counter_ns()

    @staticmethod
    def done(ev) -> bool:
        return ev.query()

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)

    @staticmethod
    def capturing(device: torch.device) -> bool:
        with torch.cuda.device(device):
            return torch.cuda.is_current_stream_capturing()


event_type = None
"""None: CUDA devices record :class:`CudaEvents` and other devices none;
a class with its interface (a test's stand-in) is used on any device."""


class Total:
    """The sums of every finished span of one name."""

    __slots__ = ("count", "host_s", "self_s", "device_s", "device_idle_s", "host_only")

    def __init__(self, host_only: bool):
        self.count = 0
        self.host_s = self.self_s = self.device_s = self.device_idle_s = 0.0
        self.host_only = host_only

    def __repr__(self):
        return (f"Total(count={self.count}, host_s={self.host_s:.6f}, self_s={self.self_s:.6f}, "
                f"device_s={self.device_s:.6f}, device_idle_s={self.device_idle_s:.6f})")


class Span:
    """A finished span. Times on the profiler's clock, in ns;
    ``device_start_ns`` (its entry event's completion), ``device_s`` and
    ``device_idle_s`` are None until its events are resolved (and stay
    None without a device, ``device_s`` for a host-only span,
    ``device_idle_s`` for one that is not)."""

    __slots__ = ("id", "name", "parent", "request", "start_ns", "end_ns", "self_ns", "device",
                 "host_only", "device_start_ns", "device_s", "device_idle_s")
    # parent: the id of the span open on the same thread when it began

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_s(self) -> float:
        return self.self_ns * 1e-9

    def __repr__(self):
        return (f"Span({self.name!r}, request={self.request!r}, host_s={self.host_s:.6f}, "
                f"device_s={self.device_s}, device_idle_s={self.device_idle_s})")


_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_totals: Dict[str, Total] = {}
_spans: List[Span] = []
_pending: list = []  # (span, events, entry event, exit event, anchor event, its wall ns)
_traced: Counter = Counter()
_anchors: dict = {}
_offset_ns = 0  # wall clock (the profiler's) less perf_counter, at switch-on
_on = False  # any area on


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _events_for(device):
    """The event class for ``device``, or None (no events there)."""
    if device is None:
        return None
    if event_type is not None:
        return event_type
    return CudaEvents if torch.device(device).type == "cuda" else None


def _anchor(events, device):
    """The anchor of ``device`` since tracing turned on, taken at its
    first use: the tracer's only wait."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (events, device)
    a = _anchors.get(key)
    if a is None:
        a = _anchors[key] = events.anchor(device)
    return a


class _Null:
    """The span and the phases of an area that is off."""

    host_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark(self, name: str) -> None:
        pass


_NULL = _Null()


class _Open:
    """A span being timed (the context manager :meth:`Area.span` returns)."""

    __slots__ = ("id", "name", "device", "host_only", "request", "parent", "start", "child_ns",
                 "events", "entry", "anchor", "host_s", "sink")

    def __init__(self, name, device, host_only, request, events, sink):
        self.name, self.device, self.host_only, self.request = name, device, host_only, request
        self.events, self.sink = events, sink
        self.child_ns = 0
        self.host_s = 0.0

    def __enter__(self):
        self.id = next(_ids)
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        if self.events is not None:
            self.anchor = _anchor(self.events, self.device)
            self.entry = self.events.record(self.device)
        self.start = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        exit_ev = None
        if self.events is not None and not self.host_only:
            exit_ev = self.events.record(self.device)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        dur = end - self.start
        self.host_s = dur * 1e-9
        if self.parent is not None:
            self.parent.child_ns += dur
        if self.sink is not None:
            key = self.name.rpartition(".")[2]
            self.sink[key] = self.sink.get(key, 0.0) + self.host_s
        timed = self.events is not None
        _finish(self.id, self.name, self.parent, self.request, self.start, end,
                dur - self.child_ns, self.device, self.host_only, self.events,
                self.entry if timed else None, exit_ev, self.anchor if timed else None)
        return False


def _finish(sid, name, parent, request, start, end, self_ns, device, host_only, events, entry,
            exit_ev, anchor) -> None:
    s = Span()
    s.id, s.name, s.request, s.host_only = sid, name, request, host_only
    s.device = None if device is None else str(device)
    s.parent = getattr(parent, "id", None)
    s.start_ns, s.end_ns, s.self_ns = start + _offset_ns, end + _offset_ns, self_ns
    s.device_start_ns = s.device_s = s.device_idle_s = None
    with _lock:
        t = _totals.get(name)
        if t is None:
            t = _totals[name] = Total(host_only)
        t.count += 1
        t.host_s += (end - start) * 1e-9
        t.self_s += self_ns * 1e-9
        if len(_spans) < MAX_SPANS:
            _spans.append(s)
        if entry is not None:
            _pending.append((s, events, entry, exit_ev, anchor[0], anchor[1] + _offset_ns))
        full = len(_pending) > MAX_PENDING
    if full:  # an area whose stage never flushes: resolve what has completed
        flush()


def flush() -> None:
    """Resolve the device times of every finished span whose events have
    completed; the others wait for a later flush. Never waits."""
    with _lock:
        pending, _pending[:] = list(_pending), []
    left = []
    for item in pending:
        s, events, entry, exit_ev, anchor, anchor_ns = item
        if not events.done(entry) or (exit_ev is not None and not events.done(exit_ev)):
            left.append(item)
            continue
        s.device_start_ns = anchor_ns + round(events.ms(anchor, entry) * 1e6)
        if exit_ev is not None:
            s.device_s = max(events.ms(entry, exit_ev), 0.0) * 1e-3
        if s.host_only:
            # the entry event completes once the work queued before the
            # span is done; from then on the queue is empty until the end
            s.device_idle_s = max(0, s.end_ns - max(s.start_ns, s.device_start_ns)) * 1e-9
        with _lock:
            t = _totals.get(s.name)  # None after a reset
            if t is not None:
                t.device_s += s.device_s or 0.0
                t.device_idle_s += s.device_idle_s or 0.0
    if left:
        with _lock:
            _pending[:0] = left


def totals() -> Dict[str, Total]:
    """Totals by span name (after a :func:`flush`)."""
    flush()
    with _lock:
        return dict(_totals)


def spans(name: Optional[str] = None) -> List[Span]:
    """The finished spans kept (of one name), in the order they ended,
    after a :func:`flush`."""
    flush()
    with _lock:
        return [s for s in _spans if name is None or s.name == name]


def snapshot() -> Dict[str, tuple]:
    """(count, host_s, device_s, device_idle_s) by span name, for
    :func:`since`."""
    with _lock:
        return {k: (t.count, t.host_s, t.device_s, t.device_idle_s) for k, t in _totals.items()}


def since(snap: Dict[str, tuple]) -> Dict[str, tuple]:
    """What each name's (count, host_s, device_s, device_idle_s) grew by
    since ``snap``."""
    now = snapshot()
    zero = (0, 0.0, 0.0, 0.0)
    return {k: tuple(a - b for a, b in zip(v, snap.get(k, zero))) for k, v in now.items()
            if v != snap.get(k, zero)}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (and to the traced counts while any
    area is on)."""
    counts[name] += n
    if _on:
        _traced[name] += n


def traced_counts() -> Dict[str, int]:
    """The counts made while any area was on."""
    return dict(_traced)


def reset() -> None:
    """Forget every total, span, pending event and count."""
    with _lock:
        _totals.clear()
        _spans.clear()
        _pending.clear()
        _traced.clear()
        counts.clear()


@contextlib.contextmanager
def holding():
    """No span of this thread records inside the block (a CUDA graph's
    warm-up and capture: set-up, not the work a replay does)."""
    _local.held = getattr(_local, "held", 0) + 1
    try:
        yield
    finally:
        _local.held -= 1


def current_request():
    """The request id of the innermost span open on this thread, or None."""
    stack = _stack()
    return stack[-1].request if stack else None


class CounterView(Mapping):
    """A read-only dict of some of :data:`counts`: ``key`` reads
    ``counts[prefix + key]``."""

    def __init__(self, prefix: str, keys):
        self.prefix, self._keys = prefix, tuple(keys)

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(key)
        return counts[self.prefix + key]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __repr__(self):
        return repr(dict(self))


class Phases:
    """Spans that tile a stretch of one thread's time: each
    :meth:`mark` ends the span begun at the previous mark (or at the
    start), named ``prefix + name``, and adds its host seconds to
    ``sink[name]``. On a device, a mark's event is both the ending span's
    exit and the next one's entry."""

    def __init__(self, prefix: str, device, sink: dict):
        self.prefix, self.sink = prefix, sink
        self.device = device
        self.events = _events_for(device)
        if self.events is not None:
            if self.events.capturing(device):
                self.events = None
            else:
                self.anchor = _anchor(self.events, device)
                self.ev = self.events.record(device)
        self.t = time.perf_counter_ns()

    def mark(self, name: str) -> None:
        now = time.perf_counter_ns()
        ev = self.events.record(self.device) if self.events is not None else None
        stack = _stack()
        parent = stack[-1] if stack else None
        dur = now - self.t
        if parent is not None:
            parent.child_ns += dur
        _finish(next(_ids), self.prefix + name, parent, getattr(parent, "request", None), self.t,
                now, dur, self.device, False, self.events,
                self.ev if ev is not None else None, ev, self.anchor if ev is not None else None)
        self.sink[name] = self.sink.get(name, 0.0) + dur * 1e-9
        self.t, self.ev = now, ev


class Area:
    """A part of the port with its own switch: ``env`` is its variable
    (a tuple: on while any of them is "1")."""

    def __init__(self, name: str, env):
        self.name = name
        self.env = (env,) if isinstance(env, str) else tuple(env)
        self.on = False
        self.forced = False

    def switch(self, device=None) -> bool:
        """At the area's entry: on while its variable is "1" or it is
        forced on. Turning tracing on takes the clock's offset, and
        ``device``'s anchor (before the entry queues any work)."""
        on = self.forced or any(os.environ.get(e) == "1" for e in self.env)
        _set(self, on)
        if on and device is not None:
            events = _events_for(device)
            if events is not None:
                _anchor(events, device)
        return on

    def force(self, on: bool) -> None:
        """Hold the area on without its variable (a library caller's
        switch), or stop holding it and switch it by its variable."""
        self.forced = on
        self.switch()

    def span(self, name: str, device=None, host_only: bool = False, request=None,
             sink: Optional[dict] = None):
        """A context manager timing a span named ``name``; ``device``
        records its events there, ``host_only`` marks a span that queues
        nothing on it, ``sink`` is a dict its host seconds are added to
        under the name's last dotted part. The returned object's ``host_s``
        holds the span's host seconds after it ends (0.0 while the area is
        off)."""
        if not self.on:
            return _NULL
        events = _events_for(device)
        if getattr(_local, "held", 0) or (events is not None and events.capturing(device)):
            return _NULL
        return _Open(name, device, host_only, request, events, sink)

    def phases(self, prefix: str, device, sink: dict):
        """A :class:`Phases` (nothing while the area is off)."""
        if not self.on:
            return _NULL
        return Phases(prefix, device, sink)


AREAS: Dict[str, Area] = {}


def _set(area: Area, on: bool) -> None:
    global _on, _offset_ns
    area.on = on
    any_on = any(a.on for a in AREAS.values())
    if any_on and not _on:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
    elif not any_on and _on:
        _anchors.clear()
    _on = any_on


def _area(name: str, env) -> Area:
    AREAS[name] = area = Area(name, env)
    return area


EMBED = _area("embed", "SVECALIGN_EMBED_PROFILE")
ALIGN = _area("align", "SVECALIGN_ALIGN_PROFILE")
SEARCH = _area("search", "SVECALIGN_SEARCH_PROFILE")
VAD = _area("vad", "SVECALIGN_VAD_PROFILE")
UNTRANS = _area("untrans", "SVECALIGN_UNTRANS_PROFILE")
TRAIN = _area("train", "SVECALIGN_TRAIN_PROFILE")
PIPELINE = _area("pipeline", tuple(a.env[0] for a in AREAS.values()))
ASR = _area("asr", "SVECALIGN_ASR_PROFILE")
