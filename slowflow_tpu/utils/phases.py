"""Lightweight cumulative phase timers, enabled by SF_PROF=1.

The reference logs per-phase wall-clock accumulators to its stats files
(slow_flow.cpp:729-732,886-890; dense_tracking.cpp:1951-1964); this is the
same discipline for these CLIs, default-off so the hot paths pay nothing.

Usage:
    with phase("epic.dt_dispatch"):
        ...
    ...
    report()            # prints the cumulative table when SF_PROF=1
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = bool(int(os.environ.get("SF_PROF", "0") or "0"))
_acc: dict = defaultdict(float)
_cnt: dict = defaultdict(int)


@contextmanager
def phase(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1


def add(name: str, seconds: float):
    if ENABLED:
        _acc[name] += seconds
        _cnt[name] += 1


def report(reset: bool = True):
    if not ENABLED or not _acc:
        return
    total = sum(_acc.values())
    print("== SF_PROF phase report (cumulative seconds) ==", flush=True)
    for name in sorted(_acc, key=_acc.get, reverse=True):
        print(f"  {name:<40} {_acc[name]:9.3f}s  x{_cnt[name]:<5} "
              f"{100.0 * _acc[name] / max(total, 1e-9):5.1f}%", flush=True)
    print(f"  {'TOTAL(instrumented)':<40} {total:9.3f}s", flush=True)
    if reset:
        _acc.clear()
        _cnt.clear()
