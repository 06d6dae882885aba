"""Timing on the card, and the peaks bounds are taken against.

Used by ``chip_smoke.py`` and ``pbrt_torch.scripts.gather_lab``; both need
a CUDA device (nothing here is meaningful on the CPU). Every kernel time
they report is ``queued_ms``: CUDA events around back-to-back calls queued
behind a spin kernel.
"""

from __future__ import annotations

import statistics
import subprocess
import time

#: H100 SXM peaks: HBM3 bytes/s and float32 outside the tensor cores (NVIDIA
#: data sheet); integer operations at the dispatch ceiling of the NVIDIA
#: H100 Tensor Core GPU Architecture white paper's SM diagram, 4 warp
#: schedulers of 32 threads/clk per SM, x 132 SMs x 1.98 GHz boost clock.
#: That is what any mix of integer pipes can issue (the compiler puts adds
#: on the FMA pipe as IMAD.IADD as well as on the 64 INT32 lanes per SM)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_I32_PER_S = 4 * 32 * 132 * 1.98e9
#: cycles of the spin kernel ``queued_ms`` enqueues its calls behind
#: (~10 ms at 1.98 GHz)
SPIN_CYCLES = 20_000_000


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Milliseconds per call of ``fn`` by CUDA events around ``n`` calls,
    after ``warm`` calls and a synchronize."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def queued_ms(fn, n: int = 50, warm: int = 5, tries: int = 3):
    """(ms per call of ``fn`` by CUDA events around ``n`` back-to-back
    calls, the host's ms to enqueue one call). The calls are enqueued
    behind a spin kernel that outlasts their enqueueing, so the device runs
    them without waiting on the host, even where a launch is shorter than
    its enqueueing. Where the host took longer than the spin (a stall of
    the shared host), the round is taken again behind a spin 4 times as
    long, up to ``tries`` rounds; then it raises."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for attempt in range(tries):
        t_host = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES * 4 ** attempt)
        ev[1].record()
        for _ in range(n):
            fn()
        t_host = (time.perf_counter() - t_host) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        spin_ms = ev[0].elapsed_time(ev[1])
        if t_host < spin_ms:
            return ev[1].elapsed_time(ev[2]) / n, t_host / n
    raise SystemExit(f"queued_ms: the host took {t_host:.3f} ms to enqueue "
                     f"{n} calls, longer than the {spin_ms:.3f} ms spin")


def queued_rounds(fn, rounds: int = 5, calls: int = 50, warm: int = 5) -> dict:
    """``rounds`` rounds of ``queued_ms`` over ``calls`` calls each (fewer
    for a launch of tens of ms), after ``warm`` calls: the median ms per
    call (``ms``), the rounds' ``min`` and ``max`` and the median host
    enqueue time per call (``host_ms``)."""
    r = [queued_ms(fn, n=calls, warm=warm) for _ in range(rounds)]
    ms = [x[0] for x in r]
    return dict(ms=statistics.median(ms), min=min(ms), max=max(ms),
                host_ms=statistics.median(x[1] for x in r))


def bound_ms(nbytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0):
    """(least time in ms, "bytes" or "operations") for moving ``nbytes`` and
    doing ``f32_ops`` float32 and ``i32_ops`` integer operations at the
    card's peak rates; the operations' time is the longer of the two kinds'."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = max(f32_ops / PEAK_F32_PER_S, i32_ops / PEAK_I32_PER_S) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
