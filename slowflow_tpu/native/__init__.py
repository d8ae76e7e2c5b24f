"""Native (C++) host-side components with lazy compilation and Python fallback.

The compute path of the framework is JAX/XLA; this module covers the
truly sequential host-side pieces — the per-seed k-NN search over the tiny
seed-adjacency graph (a settled-array Dijkstra, written independently;
fulfils the role of epic_aux.cpp:44-87) and the PNG scanline unfilter of
the frame reader (Average/Paeth rows are a left-to-right scan). The
sequential sweep distance-transform oracle lives in tests/
(tests/dt_oracle.py): it exists only to validate the device min-plus
fixpoint and is not a production path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, f) for f in ("geodesic.cpp", "png.cpp")]
_LIB = os.path.join(_HERE, "libnative.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    # build into a private file and rename it into place, so that processes
    # building at the same time never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmds = [
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
         *_SRCS, "-o", tmp],
        ["g++", "-O3", "-shared", "-fPIC", *_SRCS, "-o", tmp],
        ["cc", "-O3", "-shared", "-fPIC", *_SRCS, "-lstdc++", "-o", tmp],
    ]
    for cmd in cmds:
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0 and os.path.exists(tmp):
                os.replace(tmp, _LIB)
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def get_lib():
    """Return the loaded shared library, building it on first use.
    Returns None if no toolchain is available (callers fall back to Python)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB) or (os.path.getmtime(_LIB) < max(
                os.path.getmtime(src) for src in _SRCS)):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _build_failed = True
            return None
        lib.geodesic_knn_all.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float32, flags="C"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float32, flags="C"),
        ]
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ]
        _lib = lib
        return _lib


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int):
    """Undo the PNG scanline filters of a decompressed image stream
    (h rows of 1 + stride bytes). Returns [h, stride] uint8, or None when
    no C++ toolchain is available (the caller falls back to Python)."""
    lib = get_lib()
    if lib is None:
        return None
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    out = np.empty((h, stride), np.uint8)
    rc = lib.png_unfilter(raw, h, stride, bpp, out)
    if rc:
        raise ValueError(f"bad PNG filter type in row {-1 - rc}")
    return out


def knn_graph_all(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                  nmax: int):
    """k nearest seeds for every seed over a CSR graph.

    Returns (best [ns, nmax] int32, dist [ns, nmax] float32). Uses the C++
    Dijkstra when available, a heapq fallback otherwise.
    """
    ns = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    best = np.empty((ns, nmax), np.int32)
    dist = np.empty((ns, nmax), np.float32)
    lib = get_lib()
    if lib is not None and ns > 0:
        lib.geodesic_knn_all(ns, indptr, indices, data, nmax, best, dist)
        return best, dist
    return _knn_python(indptr, indices, data, nmax, best, dist)


def _knn_python(indptr, indices, data, nmax, best, dist):
    """Settled-array Dijkstra with lazy deletion (same as the C++ path)."""
    import heapq

    ns = len(indptr) - 1
    for src in range(ns):
        tentative = np.full(ns, np.inf, np.float64)
        settled = np.zeros(ns, bool)
        pq = [(0.0, src)]
        tentative[src] = 0.0
        found = 0
        while found < nmax and pq:
            d, u = heapq.heappop(pq)
            if settled[u]:
                continue
            settled[u] = True
            best[src, found] = u
            dist[src, found] = d
            found += 1
            for e in range(indptr[u], indptr[u + 1]):
                v = indices[e]
                cand = d + data[e]
                if not settled[v] and cand < tentative[v]:
                    tentative[v] = cand
                    heapq.heappush(pq, (cand, v))
        best[src, found:] = -1
        dist[src, found:] = np.inf
    return best, dist
