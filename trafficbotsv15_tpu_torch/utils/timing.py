"""Device timings of a callable on the current CUDA device, by CUDA events.

`cuda_ms` times warm eager calls, the host's launch cost included where it is
longer than the device's work; `graph_ms` times the same calls captured in one
CUDA graph and replayed, which is the device time alone. Both return
milliseconds per call. `card_line` names the card every timing stands beside.
"""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (the first card's line)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of iters eager calls of fn after warmup calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """Device time of one call of fn: iters calls captured in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)
