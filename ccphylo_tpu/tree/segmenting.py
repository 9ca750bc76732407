"""Host-side segmented dispatch of device join loops.

The join loop is dispatched in host-driven segments of K joins rather
than as one device program per tree.  All state (the distance matrix,
row sums, caches, join records) stays on the device; every segment
donates and re-receives the same buffers, so XLA aliases them in place
and the host round trip is one scalar fetch per segment.  Segment
boundaries are where checkpoints are taken and where a long run reports
progress; segment sizes adapt to a wall-clock target so that any
n / dtype / joins-per-second combination gets boundaries at a steady
rate.  What the boundaries cost on the GPU (the host gap between
segments) is not measured yet.

"""

from __future__ import annotations

import os
import time

import jax


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def run_segmented(seg_call, state, total: int, hooks=None,
                  start: int = 0):
    """Run `total` join steps as adaptively sized device segments.

    seg_call(state, t0, t1) -> state  — a jitted, buffer-donating
    function executing steps [t0, t1); state is an arbitrary pytree of
    device arrays.  Returns the final state.

    hooks, if given, is called as hooks(state, done, total) after every
    fenced segment (checkpointing / instrumentation); `start` resumes
    the step counter mid-run (checkpoint restore).

    Segment sizing: start at CCPHYLO_TPU_SEG (default 512) steps, then
    rescale each segment toward CCPHYLO_TPU_SEG_TARGET_S (default 4.0)
    seconds of measured device time, clamped to [128, 131072].  A fixed
    size can be forced with CCPHYLO_TPU_SEG_FIXED=1.
    """
    target_s = _env_float("CCPHYLO_TPU_SEG_TARGET_S", 4.0)
    seg = max(_env_int("CCPHYLO_TPU_SEG", 512), 1)
    fixed = os.environ.get("CCPHYLO_TPU_SEG_FIXED", "") == "1"

    def sync(state):
        # a device->host fetch of the smallest leaf fences the segment
        # (the hooks and the rescale below read the finished state)
        leaves = jax.tree_util.tree_leaves(state)
        jax.device_get(min(leaves, key=lambda x: x.size))
        return state

    done = start
    while done < total:
        k = min(seg, total - done)
        t0 = time.perf_counter()
        state = sync(seg_call(state, done, done + k))
        dt = time.perf_counter() - t0
        done += k
        if hooks is not None:
            hooks(state, done, total)
        if not fixed and done < total and k == seg:
            # steady-state rescale; the first call's dt includes
            # compile, which only ever shrinks the next segment
            seg = int(max(128, min(131072, seg * target_s / max(dt, 1e-3))))
    return state
