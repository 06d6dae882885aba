"""Timing on the card, and the peaks bounds are taken against.

Used by ``chip_smoke.py`` and ``pbrt_torch.scripts.gather_lab``; both need
a CUDA device (nothing here is meaningful on the CPU).
"""

from __future__ import annotations

import subprocess

#: H100 SXM peaks: HBM3 bytes/s and float32 outside the tensor cores (NVIDIA
#: data sheet); integer operations at the dispatch ceiling of the NVIDIA
#: H100 Tensor Core GPU Architecture white paper's SM diagram, 4 warp
#: schedulers of 32 threads/clk per SM, x 132 SMs x 1.98 GHz boost clock.
#: That is what any mix of integer pipes can issue (the compiler puts adds
#: on the FMA pipe as IMAD.IADD as well as on the 64 INT32 lanes per SM)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_I32_PER_S = 4 * 32 * 132 * 1.98e9


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


def device_ms(fn, match: str, n: int = 20, warm: int = 3) -> float:
    """Mean device time in ms of one launch of the kernel whose name holds
    ``match``, over ``n`` calls of ``fn`` under ``torch.profiler`` (after
    ``warm`` calls). Events around a launch that takes a few microseconds
    time the host's launch cost instead; this is the kernel's own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and match in e.key]
    count = sum(e.count for e in ev)
    if count != n:
        raise RuntimeError(f"device_ms: traced {count} launches of {match!r}, "
                           f"expected {n}")
    return sum(e.self_device_time_total for e in ev) / 1e3 / count


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
