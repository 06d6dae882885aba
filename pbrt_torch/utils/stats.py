"""Counters, timers, a progress bar and a device trace (port of
``pbrt_tpu/utils/stats.py``; reference: src/core/probes.{h,cpp},
progressreporter.{h,cpp}, timer.{h,cpp}).

Host-side counters and wall timers keyed by name, printed by ``report``
(ProbesPrint), and ``device_trace``, a ``torch.profiler`` scope (CUDA
activity where a card is present) written for TensorBoard, where the JAX
package wraps ``jax.profiler``. As in the JAX package, the render path
calls none of them: they are for a user's own scripts.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import tempfile
import time
from collections import defaultdict

_counters: dict = defaultdict(int)
_timers: dict = defaultdict(float)
_timer_counts: dict = defaultdict(int)
_enabled = True


def incr(name: str, n: int = 1):
    """A named counter (PBRT_*_COUNTER)."""
    if _enabled:
        _counters[name] += n


@contextlib.contextmanager
def timed(name: str):
    """A scoped wall timer, summed per name with its call count."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _timers[name] += time.perf_counter() - t0
        _timer_counts[name] += 1


def set_enabled(v: bool):
    """Turns the counters (not the timers) on or off, as the JAX module's."""
    global _enabled
    _enabled = v


def report() -> str:
    """The counters, then the timers, one per line (ProbesPrint)."""
    lines = ["pbrt_torch statistics:"]
    for k in sorted(_counters):
        lines.append(f"  {k:<44s} {_counters[k]:>14,d}")
    for k in sorted(_timers):
        lines.append(f"  {k:<44s} {_timers[k]:>12.3f}s ({_timer_counts[k]} calls)")
    return "\n".join(lines)


def print_report_at_exit():
    atexit.register(lambda: print(report()))


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """A ``torch.profiler`` trace of the scope (the CPU's ops, and the
    card's kernels where a card is present) written to ``logdir`` (default:
    ``pbrt_torch_trace`` in the temporary directory) for TensorBoard;
    yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    logdir = logdir or os.path.join(tempfile.gettempdir(), "pbrt_torch_trace")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


class ProgressReporter:
    """A terminal progress bar (progressreporter.{h,cpp})."""

    def __init__(self, total: int, title: str = "Rendering", quiet=False):
        self.total = max(total, 1)
        self.title = title
        self.done = 0
        self.quiet = quiet
        self.t0 = time.time()

    def update(self, n: int = 1):
        self.done += n
        if self.quiet:
            return
        frac = self.done / self.total
        width = 40
        fill = int(frac * width)
        el = time.time() - self.t0
        eta = el / max(frac, 1e-9) * (1 - frac)
        print(f"\r{self.title}: [{'+' * fill}{' ' * (width - fill)}] ({el:.1f}s|{eta:.1f}s)",
              end="", flush=True)

    def finish(self):
        if not self.quiet:
            self.update(0)
            print()
