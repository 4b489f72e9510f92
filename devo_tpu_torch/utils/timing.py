"""The port's tracer (counterpart of devo_tpu/utils/timing.py, after
upstream DEVO's torch.profiler integration, train.py:143-152): spans and
counters at the layer boundaries, on torch.profiler's clock.

`span(name, **attrs)` marks a block (or, as a decorator, a function). While
tracing is off, which is the default, a span is a small object whose entry
tests one module-level flag and does nothing else: no timestamp, no record,
no `record_function`. While tracing is on (inside `recording()` or
`trace()`), a span enters `torch.profiler.record_function(name)`, so that
it shows in any profile taken meanwhile, and on leaving appends

    (id, parent id, step, thread, name, t0_ns, t1_ns, attrs)

to the recording's `spans`. t0_ns and t1_ns are `time.time_ns()`, the
Unix-epoch clock that torch.profiler's events carry (`start_ns()`,
`end_ns()`), kernels included, so a span and the kernels launched inside
it can be set side by side.

The stack of open spans is per thread. A span opened on a thread with no
open span takes as its parent the innermost span open on the thread of the
root span that is open, if any: in the train step that is `train.backward`,
while autograd runs the backward and remat's recompute on its own device
thread. A span opened with no span open anywhere is a root; the `step`
attr of a root (`train.step`) is the `step` of every span and count until
the next root.

`count(name, n)` adds n to the counter (step, name) of the recording,
under the same flag. `upload` and `read` are the blocking copies between
the host and a device that the train step makes, each counted as one
`host_waits` whatever the device.

devo_tpu's `enable_compilation_cache` sets XLA's persistent compilation
cache and has no counterpart here: the port runs eagerly, and its kernels
are built once into devo_tpu_torch/_build/, keyed by a hash of their
sources, and loaded from there by every later process.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

_on = False                  # the flag every span and count tests first


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    step: Optional[int]
    thread: int
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


class Recording(NamedTuple):
    """What one `recording()` collected: the closed spans in the order they
    closed, and the counters by (step, name)."""
    spans: List[Span]
    counts: Dict[Tuple[Optional[int], str], int]


_rec: Optional[Recording] = None
_ids = itertools.count()
_local = threading.local()
_count_lock = threading.Lock()   # counts may come from autograd's thread too
_root_stack: Optional[list] = None   # the stack of the thread of the open root
_step: Optional[int] = None


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """A span named `name` with `attrs` (see the module's docstring); a
    context manager, and a decorator that opens it around each call."""

    __slots__ = ("name", "attrs", "_open")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._open = None

    def __enter__(self):
        if not _on:
            return self
        global _root_stack, _step
        stack = _stack()
        if stack:
            parent = stack[-1][0]
        elif _root_stack:
            parent = _root_stack[-1][0]
        else:
            parent = None
            _root_stack = stack
            _step = self.attrs.get("step")
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self._open = (next(_ids), parent, _step, rf, time.time_ns())
        stack.append(self._open)
        return self

    def __exit__(self, *exc):
        if self._open is None:
            return False
        t1 = time.time_ns()
        sid, parent, step, rf, t0 = self._open
        self._open = None
        _stack().pop()
        rf.__exit__(None, None, None)
        if _rec is not None:
            _rec.spans.append(Span(sid, parent, step, threading.get_ident(),
                                   self.name, t0, t1, self.attrs))
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with span(name, **attrs):
                return fn(*args, **kwargs)

        return spanned


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` of the current step while tracing."""
    if _on:
        key = (_step, name)
        with _count_lock:
            _rec.counts[key] = _rec.counts.get(key, 0) + n


def upload(data, device) -> torch.Tensor:
    """`torch.as_tensor(data, device=device)`, a blocking copy from the
    host where `device` is a card, counted as one `host_waits`."""
    count("host_waits")
    return torch.as_tensor(data, device=device)


def read(t: torch.Tensor):
    """The Python number of a one-element tensor: a blocking read from
    its device, counted as one `host_waits`."""
    count("host_waits")
    return t.item()


@contextlib.contextmanager
def recording():
    """Tracing on for the block; yields the `Recording` it fills. A
    recording inside another takes over until it ends."""
    global _on, _rec, _root_stack, _step
    saved = (_on, _rec, _root_stack, _step)
    rec = Recording([], {})
    _on, _rec, _root_stack, _step = True, rec, None, None
    try:
        yield rec
    finally:
        _on, _rec, _root_stack, _step = saved


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block into `logdir` (one
    `*.pt.trace.json` file) with tracing on, so that the spans show in it.
    Yields the profiler, whose `key_averages()` the caller may read after
    the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with recording(), torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof
