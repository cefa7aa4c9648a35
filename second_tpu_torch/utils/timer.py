"""Spans and counts of the port's stages, and the named-region timer
built on them (``ModelTimer``, twin of ``second_tpu/utils/timer.py``;
reference second/utils/timer.py and the named-region timers of
voxelnet.py:191-228).

One registry per process. A span records its name, its host start and
end (``time.perf_counter_ns``), the request it belongs to and its
thread; a count adds to a named counter of the current request.
Collection is off by default: ``span`` then costs two flag checks and
returns a shared no-op context, and ``count`` returns at once.
``collect(True)`` turns it on for the whole process, ``snapshot()``
returns what is kept in memory and ``reset()`` clears it; nothing is
written out unless the caller does it.

Whenever a ``torch.profiler`` is recording, collection on or off, a
span also opens a ``record_function`` range of its name, so the stage
sits on the profiler's timeline beside the kernels it launched.

A request is a number that ``new_request`` hands out while collection
is on (None while it is off); ``request(rid)`` makes it the current
request of the calling thread, so spans and counts of one request made
on two threads (a loader's and the caller's) share it.
``InferenceContext`` carries it from ``get_inference_input_dict`` to
``inference`` under the batch key ``REQUEST_KEY``.
"""

import contextlib
import itertools
import threading
import time
from collections import defaultdict, namedtuple

import torch
from torch.autograd import profiler as _profiler

# the batch key that carries a request's id from the host preparation to
# the device path (not a device input: example_convert drops it)
REQUEST_KEY = "trace_request"

Span = namedtuple("Span", "name start_ns end_ns request thread")

_NOOP = contextlib.nullcontext()


class _Registry:
    def __init__(self):
        self.on = False
        self.spans = []
        self.counts = defaultdict(int)  # (request, name) -> n
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()  # .request, .stage


_REG = _Registry()


def collect(on):
    """Turn collection on or off for the process; returns the state it
    had."""
    was, _REG.on = _REG.on, bool(on)
    return was


def collecting():
    return _REG.on


def snapshot():
    """{"spans": [Span], "counts": {request: {name: n}}} kept so far."""
    with _REG.lock:
        spans = list(_REG.spans)
        counts = defaultdict(dict)
        for (rid, name), n in _REG.counts.items():
            counts[rid][name] = n
    return {"spans": spans, "counts": dict(counts)}


def reset():
    with _REG.lock:
        _REG.spans.clear()
        _REG.counts.clear()


def current_request():
    return getattr(_REG.local, "request", None)


def new_request():
    """A fresh request id while collection is on, else None."""
    return next(_REG.ids) if _REG.on else None


@contextlib.contextmanager
def _bind(rid):
    local = _REG.local
    outer = getattr(local, "request", None)
    local.request = rid
    try:
        yield rid
    finally:
        local.request = outer


def request(rid):
    """Context in which ``rid`` is the calling thread's current request
    (a no-op for None)."""
    return _NOOP if rid is None else _bind(rid)


class _Span:
    __slots__ = ("name", "keep", "range", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.keep = _REG.on
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.keep:
            _REG.spans.append(Span(self.name, self.start, end,
                                   current_request(), threading.get_ident()))
        if self.range is not None:
            self.range.__exit__(*exc)


def span(name):
    """Context that records a span of ``name`` while collection is on and
    opens a profiler range of it while a profiler records."""
    if not (_REG.on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name)


def count(name, n):
    """Add ``n`` to the current request's counter ``name``."""
    if not _REG.on:
        return
    key = (current_request(), name)
    with _REG.lock:
        _REG.counts[key] += n


def stage(name):
    """Close the calling thread's open stage, if any, and open a span of
    ``name`` as the next one (None opens none): consecutive stages of one
    function, without nesting. The function calls ``stage(None)`` in a
    ``finally``, so that the last stage closes however it returns."""
    local = _REG.local
    open_ = getattr(local, "stage", None)
    if open_ is not None:
        local.stage = None
        open_.__exit__(None, None, None)
    if name is not None:
        s = span(name)
        if s is not _NOOP:
            local.stage = s.__enter__()


class ModelTimer:
    """Named-region timer (reference start_timer/end_timer) over the
    registry: enabled, it turns collection on until ``close``, its
    regions are spans, and ``get_avg_time_dict`` averages every span kept
    by name, the stages' spans of the port among them. On CUDA a region
    that asks for a sync ends with ``torch.cuda.synchronize()``, so the
    device work it launched is inside its time."""

    def __init__(self, enabled=True):
        self._enabled = enabled
        self._open = {}
        self._was_on = collect(True) if enabled else None

    def start(self, name):
        if self._enabled:
            self._open[name] = span(name).__enter__()

    def end(self, name, sync=False):
        if not self._enabled:
            return
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        s = self._open.pop(name)
        if s is not None:
            s.__exit__(None, None, None)

    @contextlib.contextmanager
    def scope(self, name, sync=False):
        self.start(name)
        yield
        self.end(name, sync)

    def get_avg_time_dict(self):
        """{name: mean seconds} of the spans kept since the last clear."""
        totals, counts = defaultdict(float), defaultdict(int)
        for s in snapshot()["spans"]:
            totals[s.name] += (s.end_ns - s.start_ns) * 1e-9
            counts[s.name] += 1
        return {k: totals[k] / counts[k] for k in totals}

    def clear(self):
        reset()

    def close(self):
        """Give collection back the state it had before this timer."""
        if self._enabled:
            collect(self._was_on)
            self._enabled = False
