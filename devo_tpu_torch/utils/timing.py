"""Profiling helpers (counterpart of devo_tpu/utils/timing.py, after
upstream DEVO's CUDA-event Timer, devo/utils.py:5-28, and its torch.profiler
integration, train.py:143-152).

`Timer` times a section by the wall clock; with `sync` (a tensor or a
device) it first waits for that device's queued work
(`torch.cuda.synchronize`), so that the time covers the kernels the section
launched. `named_scope` is `torch.profiler.record_function`, the span the
engine's phases already carry (devo.patchify, devo.update, ...). `trace`
records a `torch.profiler` run with CPU and, where there is a card, CUDA
activity, written by `tensorboard_trace_handler` as a Chrome trace that
TensorBoard's profiler plugin and chrome://tracing read.

devo_tpu's `enable_compilation_cache` sets XLA's persistent compilation
cache and has no counterpart here: the port runs eagerly, and its kernels
are built once into devo_tpu_torch/_build/, keyed by a hash of their
sources, and loaded from there by every later process.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

all_times: Dict[str, List[float]] = defaultdict(list)


def _sync(target):
    """Wait for the work queued on the CUDA device of `target` (a tensor
    or a device); nothing to wait for on the CPU."""
    dev = target.device if torch.is_tensor(target) else torch.device(target)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Section timer in milliseconds, kept in `all_times[name]`; `sync`
    waits for the device of that tensor (or that device) before stopping."""

    def __init__(self, name: str, enabled: bool = True, sync=None):
        self.name = name
        self.enabled = enabled
        self.sync = sync

    def __enter__(self):
        if self.enabled:
            if self.sync is not None:
                _sync(self.sync)
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            if self.sync is not None:
                _sync(self.sync)
            elapsed = (time.perf_counter() - self.start) * 1e3
            all_times[self.name].append(elapsed)
            print(f"{self.name} {elapsed:.3f} ms")


def named_scope(name: str):
    """A span that torch.profiler records (on the CPU timeline, with the
    kernels it launches beneath it)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block into `logdir` (one
    `*.pt.trace.json` file). Yields the profiler, whose `key_averages()`
    the caller may read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof


def summarize() -> Dict[str, float]:
    """The mean milliseconds of each timed section."""
    return {k: sum(v) / max(len(v), 1) for k, v in all_times.items()}
