"""Profiling hooks, as the JAX package's ``utils/profiling.py`` (the
reference has none; its only timing is wall-clock prints bracketing a run).
"""

from __future__ import annotations

import contextlib
import time

import torch


def _synchronize() -> None:
    """Wait for the card's outstanding work (nothing to wait for without
    one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (the card's kernels
    too, where there is one) into ``log_dir`` as a ``*.pt.trace.json`` that
    TensorBoard's profiler plugin reads (or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def time_block(name: str, results: dict = None):
    """Wall-clock a block after waiting for outstanding device work, before
    and after: the seconds go into ``results[name]``, or are printed as
    ``[time] name: 1.234s``."""
    _synchronize()
    t0 = time.perf_counter()
    yield
    _synchronize()
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    else:
        print(f"[time] {name}: {dt:.3f}s")
