"""Phase timing, throughput counters, and JAX profiler hooks.

The reference's observability is two stderr timing lines around matrix
load and tree construction (tree.c:81-109); those exact lines are
emitted unconditionally by the CLI for parity.  This module adds the
framework's own instrumentation, off by default so stdout/stderr stay
reference-shaped:

- CCPHYLO_TPU_PROFILE=stderr  — per-phase wall times + throughput
  counters (pairs/s, joins/s) reported to stderr at process exit.
- CCPHYLO_TPU_PROFILE=<dir>   — additionally wraps the process in a
  JAX profiler trace written to <dir> (viewable in TensorBoard /
  Perfetto).
"""

from __future__ import annotations

import atexit
import os
import sys
import time
from contextlib import contextmanager

_MODE = os.environ.get("CCPHYLO_TPU_PROFILE", "")
_phases: dict[str, float] = {}
_counters: dict[str, float] = {}
_registered = False
_trace_started = False


def enabled() -> bool:
    return bool(_MODE)


def _report() -> None:
    global _trace_started
    if _trace_started:
        try:
            import jax
            jax.profiler.stop_trace()
        except Exception:  # noqa: BLE001 - profiling must never kill a run
            pass
        _trace_started = False
    if not _phases and not _counters:
        return
    w = sys.stderr
    w.write("# --- ccphylo_tpu profile ---\n")
    for name, secs in _phases.items():
        line = f"# phase {name}: {secs:.3f} s"
        rate_key = name + "/items"
        if rate_key in _counters and secs > 0:
            line += f"  ({_counters[rate_key] / secs:,.0f} items/s)"
        w.write(line + "\n")
    for name, val in _counters.items():
        if not name.endswith("/items"):
            w.write(f"# counter {name}: {val:,.0f}\n")
    w.flush()


def _ensure_registered() -> None:
    global _registered, _trace_started
    if _registered or not _MODE:
        return
    _registered = True
    if _MODE not in ("stderr", "1"):
        try:
            import jax
            os.makedirs(_MODE, exist_ok=True)
            jax.profiler.start_trace(_MODE)
            _trace_started = True
        except Exception as exc:  # noqa: BLE001
            print(f"# profiler trace unavailable: {exc}", file=sys.stderr)
    atexit.register(_report)


@contextmanager
def phase(name: str, items: float | None = None):
    """Time a named phase; optional item count for a rate line."""
    if not _MODE:
        yield
        return
    _ensure_registered()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _phases[name] = _phases.get(name, 0.0) + dt
        if items is not None:
            k = name + "/items"
            _counters[k] = _counters.get(k, 0.0) + items


def count(name: str, val: float = 1.0) -> None:
    if not _MODE:
        return
    _ensure_registered()
    _counters[name] = _counters.get(name, 0.0) + val
