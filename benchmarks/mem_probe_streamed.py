"""AOT memory probe for the streamed segment at beyond-device-memory
shapes.

Compiles `_streamed_segment` for the default backend WITHOUT allocating
the cache (ShapeDtypeStruct lowering) and prints XLA's buffer-assignment
memory analysis, to check that a large program fits device memory
before paying a multi-hour run (defensive whole-cache copies from a
lax.cond state fork, or a rank-3 unpack intermediate, show up here).

Usage: python benchmarks/mem_probe_streamed.py [n] [X] [F] [kbatch]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from ccphylo_tpu.tree import streamed_engine as se


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 212992
    X = int(sys.argv[2]) if len(sys.argv) > 2 else 49152
    F = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    kbatch = int(sys.argv[4]) if len(sys.argv) > 4 else 128
    ub = int(sys.argv[5]) if len(sys.argv) > 5 else 2048
    W = n // 4
    s = jax.ShapeDtypeStruct
    u32, i32 = jnp.uint32, jnp.int32
    args = (
        s((X, W), u32),          # cache
        s((n,), i32),            # slotof
        s((X,), i32),            # rowof
        s((n,), i32),            # sD2
        s((n,), i32),            # Q
        s((n,), i32),            # P
        s((), i32),              # seed
        s((n,), i32),            # I
        s((n,), i32),            # J
        s((n,), i32),            # DIJ2
        s((n,), i32),            # SDI2
        s((n,), i32),            # SDJ2
        s((8,), i32),            # stats
        s((), i32),              # t
        s((), jnp.bool_),        # ok
        s((se.MMAX,), i32),      # miss
        s((ub, W), u32),         # up_words (bucketed batch)
        s((ub,), i32),           # up_slots
        s((ub,), i32),           # up_rows
    )
    lowered = se._streamed_segment.lower(
        *args, jnp.int32(0), n, n=n, X=X, kbatch=kbatch)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    gib = 1 << 30
    print(f"n={n} X={X} F={F} kbatch={kbatch} W={W}")
    print(f"  argument bytes : {ma.argument_size_in_bytes / gib:.3f} GiB")
    print(f"  output bytes   : {ma.output_size_in_bytes / gib:.3f} GiB")
    print(f"  temp bytes     : {ma.temp_size_in_bytes / gib:.3f} GiB")
    print(f"  alias bytes    : {ma.alias_size_in_bytes / gib:.3f} GiB")
    peak = (ma.argument_size_in_bytes + ma.output_size_in_bytes
            + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    print(f"  peak (arg+out+temp-alias): {peak / gib:.3f} GiB")


if __name__ == "__main__":
    main()
