#!/usr/bin/env python
"""Tree-construction throughput: device DNJ engine vs the reference C.

- device side: random symmetric distance matrix generated on the device
  (no host transfer), full DNJ join loop
  (`ccphylo_tpu.tree.jax_engine.dnj_joins`), timed post-compile.
- C side (optional, --with-c): same-sized random matrix written as
  Phylip, `ccphylo tree -m dnj` wall time (includes its load, as ours
  includes the transfer of join records).

Usage: python benchmarks/bench_tree.py [-n 4096] [--with-c /path/ccphylo]
"""

import argparse
import functools
import io
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# persistent XLA compile cache: without it every fresh process pays
# every compile again
from ccphylo_tpu.utils.jaxconfig import configure_jax
configure_jax()


def device_dnj(n: int, reps: int = 2, quantized: str | None = None,
               compile_run: bool = True) -> float:
    import jax
    import jax.numpy as jnp
    from ccphylo_tpu.tree.jax_engine import dnj_joins, dnj_joins_q, _pad

    npad = _pad(n)

    def make_D(key):
        # symmetric-by-construction from 1-D embeddings; NOT jitted on
        # its own: callers jit it so the f32 intermediate fuses into
        # their output instead of materializing (17 GB at n=65536)
        x = jax.random.uniform(key, (npad,), jnp.float32, 0.0, 1.0)
        y = jax.random.uniform(jax.random.fold_in(key, 1), (npad,),
                               jnp.float32, 0.0, 1.0)
        idx = jnp.arange(npad)
        active = idx < n
        D = jnp.abs(x[:, None] - x[None, :]) \
            + jnp.abs(y[:, None] - y[None, :]) + 0.01
        D = jnp.where(idx[:, None] == idx[None, :], 0.0, D)
        return jnp.where(active[:, None] & active[None, :], D, -1.0)

    qdt = {"u8": jnp.uint8, "u16": jnp.uint16}.get(quantized or "")
    bs = 100.0 if quantized == "u8" else 25000.0

    @jax.jit
    def make_Dq(key):
        D = make_D(key)
        return jnp.floor(jnp.maximum(D, 0.0) * bs + 0.5).astype(qdt)

    make_Df = jax.jit(make_D)

    def run(seed):
        if qdt is not None:
            Dq = make_Dq(jax.random.PRNGKey(seed))
            I, J, LI, LJ, dl, _ = dnj_joins_q(
                Dq, jnp.int32(n), jnp.asarray(bs, jnp.float32),
                store_dtype=qdt)
        else:
            D = make_Df(jax.random.PRNGKey(seed))
            I, J, LI, LJ, dl, _ = dnj_joins(D, jnp.int32(n), scan="batch")
        return int(I.sum())  # scalar fetch forces completion

    if compile_run:
        run(0)  # compile
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        run(r + 1)
        best = min(best, time.perf_counter() - t0)
    return best


def device_dnj_packed(n: int, nb: int = 1, reps: int = 2,
                      compile_run: bool = True,
                      kbatch: int = 128) -> float:
    """Single-buffer u32-packed exact-int DNJ (the 100k+-taxa path).

    The words buffer is generated on device in 8192-row group programs
    (one group transient at a time; no full-matrix f32 intermediate
    ever materializes)."""
    import jax.numpy as jnp
    from benchmarks.synth import device_words
    from ccphylo_tpu.tree.packed_engine import (dnj_joins_packed,
                                                limbs_host)

    def run(seed):
        # synthetic tie-dense integer matrix, generated on device into
        # one donated buffer (benchmarks/synth.py; identical values to
        # the .phy the C side reads)
        words = device_words(n, mod=97 + seed)
        I, J, DIJ2, SDI2, SDJ2, dl2, _ = dnj_joins_packed(
            words, jnp.int32(n), kbatch=kbatch)
        limbs_host(I, J, DIJ2, SDI2, SDJ2, n, 1.0)
        return int(I.sum())  # scalar fetch forces completion

    if compile_run:
        run(0)  # compile
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        run(r + 1)
        best = min(best, time.perf_counter() - t0)
    return best


def c_dnj(n: int, binary: str) -> float:
    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    rng = np.random.RandomState(0)
    M = rng.uniform(0.01, 1.0, (n, n))
    M = (M + M.T) / 2
    flat = M[np.tril_indices(n, -1)]
    names = [Name(b"s%06d" % i, 32) for i in range(n)]
    buf = io.BytesIO()
    print_phy(buf, n, flat, names)
    path = "/tmp/bench_tree_%d.phy" % n
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
    threads = min(64, os.cpu_count() or 1)
    t0 = time.perf_counter()
    subprocess.run([binary, "tree", "-m", "dnj", "-t", str(threads),
                    "-i", path, "-o", "/dev/null"],
                   check=True, capture_output=True)
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=4096)
    ap.add_argument("--quantized", choices=["u8", "u16"], default=None)
    ap.add_argument("--packed", action="store_true",
                    help="single-buffer u32-packed exact-int u8 engine")
    ap.add_argument("--blocks", type=int, default=1,
                    help="(compat; ignored — single-buffer layout)")
    ap.add_argument("--kbatch", type=int, default=128,
                    help="scan revalidation batch rows")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--no-compile-run", action="store_true",
                    help="skip the warm-up run (huge n: time incl. "
                         "segment-boundary recompiles, stated as such)")
    ap.add_argument("--with-c", default=None,
                    help="path to the reference ccphylo binary")
    args = ap.parse_args()
    n = args.n
    cr = not args.no_compile_run

    if args.packed:
        t_dev = device_dnj_packed(n, nb=args.blocks, reps=args.reps,
                                  compile_run=cr, kbatch=args.kbatch)
        tag = " [packed u8 int]"
    else:
        t_dev = device_dnj(n, quantized=args.quantized, reps=args.reps,
                           compile_run=cr)
        tag = f" [{args.quantized}]" if args.quantized else ""
    joins = n - 2
    print(f"device dnj{tag}: n={n}  {t_dev:.3f}s  {joins / t_dev:,.0f} joins/s")
    if args.with_c:
        t_c = c_dnj(n, args.with_c)
        print(f"C dnj:      n={n}  {t_c:.3f}s  {joins / t_c:,.0f} joins/s  "
              f"(device is {t_c / t_dev:.2f}x)")


if __name__ == "__main__":
    main()
