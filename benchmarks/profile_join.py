#!/usr/bin/env python
"""Per-join device-time profiler for the join engines.

Runs one compile segment + one timed warm segment + one traced warm
segment of SEG joins on the current backend, then reduces the trace's
device planes: kernel time per join, kernel launches per join, device
busy share of the traced window, and the top kernels by total time.

Usage:
  python benchmarks/profile_join.py packed  -n 20000 [--trace-dir D]
  python benchmarks/profile_join.py sharded -n 32768 [--ndev 1]
"""

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from ccphylo_tpu.utils.jaxconfig import configure_jax

configure_jax()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SEG = 128


def _sync(x):
    jax.device_get(jax.tree_util.tree_leaves(x)[4])
    return x


def drive_packed(n):
    from benchmarks.synth import device_words
    from ccphylo_tpu.tree.packed_engine import (_packed_init,
                                                _packed_segment)
    words = device_words(n)
    jax.block_until_ready(words)
    mj = jnp.int32(n)
    sD2, Q, P, seed = _packed_init(words, mj)
    state = (words, sD2, Q, P, seed,
             jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
             jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
             jnp.zeros(n, jnp.int32), jnp.zeros(4, jnp.int32))

    def seg(state, t0):
        return _packed_segment(*state, jnp.int32(t0),
                               jnp.int32(t0 + SEG), mj, kbatch=128)
    return state, seg


def drive_sharded(n, ndev):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from benchmarks.synth import cell_hash_np
    from ccphylo_tpu.parallel.sharded_dnj import (_dnj_programs,
                                                  _pad_to)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("d",))
    npad = _pad_to(n, 128 * ndev)
    ii, jj = np.meshgrid(np.arange(npad, dtype=np.uint32),
                         np.arange(npad, dtype=np.uint32),
                         indexing="ij")
    Dp = cell_hash_np(ii, jj, 97).astype(np.float32)
    Dp[n:, :] = -1.0
    Dp[:, n:] = -1.0
    np.fill_diagonal(Dp[:n, :n], 0.0)
    Dd = jax.make_array_from_callback(
        Dp.shape, NamedSharding(mesh, P("d", None)),
        lambda idx: Dp[idx])
    init_fn, seg_fn = _dnj_programs(mesh, "d", npad, n, "float32",
                                    False)
    sDd, Nd, Qd, Pd, seed = init_fn(Dd)
    rep = NamedSharding(mesh, P())
    T = max(n - 2, 1)
    state = (Dd, sDd, Nd, Qd, Pd, seed,
             jax.device_put(np.zeros(T, np.int32), rep),
             jax.device_put(np.zeros(T, np.int32), rep),
             jax.device_put(np.zeros(T, np.float32), rep),
             jax.device_put(np.zeros(T, np.float32), rep))

    def seg(state, t0):
        return seg_fn(*state, jnp.int32(t0), jnp.int32(t0 + SEG))
    return state, seg


def summarize_trace(tdir, joins, window_s):
    """Reduce the newest trace under `tdir`: events on the device
    planes' stream lines (one per kernel or copy) are the launches."""
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                             recursive=True))
    if not files:
        print("no trace file found")
        return
    pd = ProfileData.from_file(files[-1])
    tot, cnt, spans = {}, {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns
                cnt[ev.name] = cnt.get(ev.name, 0) + 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        print("no device stream events in the trace")
        return
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(tot.values())
    launches = sum(cnt.values())
    print(f"\ndevice kernel time {total / 1e6:.2f} ms over {joins} joins "
          f"= {total / 1e6 / joins:.4f} ms/join; {launches} launches "
          f"= {launches / joins:.1f} launches/join; device busy "
          f"{busy / 1e6:.2f} ms of the {1e3 * window_s:.2f} ms window")
    for name, d in sorted(tot.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {d / 1e6:9.3f} ms  {100 * d / max(total, 1e-9):5.1f}%"
              f"  x{cnt[name]:<7d} {name[:120]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("engine", choices=["packed", "sharded"])
    ap.add_argument("-n", type=int, default=32768)
    ap.add_argument("--ndev", type=int, default=1)
    ap.add_argument("--trace-dir", default="profile_traces",
                    help="where the traced segment's profile is written")
    args = ap.parse_args()

    print(f"backend={jax.default_backend()} engine={args.engine} "
          f"n={args.n}", flush=True)
    if args.engine == "packed":
        state, seg = drive_packed(args.n)
    else:
        state, seg = drive_sharded(args.n, args.ndev)

    t0 = time.perf_counter()
    state = _sync(seg(state, 0))
    print(f"seg0 (incl. compile) {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    state = _sync(seg(state, SEG))
    dt = time.perf_counter() - t0
    print(f"seg1 warm: {dt:.2f}s = {1e3 * dt / SEG:.2f} ms/join",
          flush=True)
    tdir = os.path.join(args.trace_dir, f"{args.engine}_{args.n}")
    os.makedirs(tdir, exist_ok=True)
    with jax.profiler.trace(tdir):
        t0 = time.perf_counter()
        state = _sync(seg(state, 2 * SEG))
        dt = time.perf_counter() - t0
    summarize_trace(tdir, SEG, dt)


if __name__ == "__main__":
    main()
