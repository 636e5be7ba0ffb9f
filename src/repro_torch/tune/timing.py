"""Median wall-clock timers (port of the reference ``tune/timing.py``).

Host timing is noisy, so each timer reports a median, and the pair and
round-robin timers interleave their variants so that slow drift hits all
of them alike.  On a CUDA device each sample waits for the device
(``torch.cuda.synchronize``) before and after the call, so it times the
work the call queued, not its launch.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Sequence, Tuple

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _sample(fn: Callable[[], object]) -> float:
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    return time.perf_counter() - t0


def timeit_us(fn: Callable[[], object], iters: int = 5) -> float:
    """Median µs of ``fn`` over ``iters`` runs after one warm-up call
    (which also builds the kernels it launches)."""
    fn()
    return statistics.median(_sample(fn) for _ in range(iters)) * 1e6


def timeit_pair(fn_a: Callable[[], object], fn_b: Callable[[], object],
                iters: int) -> Tuple[float, float]:
    """Median µs of two variants, iterations interleaved A, B."""
    fn_a()
    fn_b()
    ta, tb = [], []
    for _ in range(iters):
        ta.append(_sample(fn_a))
        tb.append(_sample(fn_b))
    return statistics.median(ta) * 1e6, statistics.median(tb) * 1e6


def timeit_round_robin(fns: Sequence[Callable[[], object]],
                       iters: int) -> list:
    """Median µs of each of ``fns``: one pass warms every one, then each
    iteration visits them all in order."""
    for fn in fns:
        fn()
    samples = [[] for _ in fns]
    for _ in range(iters):
        for i, fn in enumerate(fns):
            samples[i].append(_sample(fn))
    return [statistics.median(s) * 1e6 for s in samples]
