"""Persistent XLA compilation cache location.

Every entry point calls `enable_compile_cache()` before its first compile.
`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache lives at
a fixed `.jax_cache/` in the checkout root. The path is part of the cache's
key, so a fixed one is what lets a second process reuse the first's compiles.
"""
from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory `enable_compile_cache` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.
    Returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class CompileClock:
    """Wall time spent tracing, lowering and compiling (persistent-cache
    lookups included) while the context is open: the union of JAX's own
    compile-event spans, so nested traces and compiles on other threads are
    not counted twice.

    >>> with CompileClock() as clock:
    ...     run()
    >>> clock.seconds()
    """

    def __init__(self):
        self._spans = []

    def _on_span(self, event, start, end, **kwargs):
        if event in _COMPILE_EVENTS:
            self._spans.append((start, end))

    def __enter__(self):
        import jax

        jax.monitoring.register_event_time_span_listener(self._on_span)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_time_span_listener(self._on_span)

    def seconds(self, since: float = float("-inf")) -> float:
        """Union length of the recorded spans that start at or after
        `since` (a `time.time()` stamp)."""
        total, reach = 0.0, float("-inf")
        for start, end in sorted(s for s in self._spans if s[0] >= since):
            if end > reach:
                total += end - max(start, reach)
                reach = end
        return total
