#!/usr/bin/env python
"""Scale parity chain for the exact-integer packed DNJ engine.

A float engine can flip a late Q tie on one ulp; the integer engine
removes that failure class by construction.  This script is the
committed evidence chain:

  1. --vs-batch     packed records (this backend) vs the unpacked
                    quantized batch engine under f64 (CPU-exact on
                    these half-integer values), at any n.
  2. --phy + --c    full Newick byte comparison against the reference
                    binary (`ccphylo tree -m dnj -b`) on the SAME
                    synthetic matrix (benchmarks/synth.py hash; the
                    .phy is written by gen mode) — the strongest
                    possible parity statement, used at n=100000.
  3. plain          run the packed engine and print join throughput +
                    a records digest (cross-backend digests must be
                    bit-identical: integer arithmetic).

Usage:
  python benchmarks/parity_chain.py gen -n 100000 --phy /tmp/big.phy
  python benchmarks/parity_chain.py run -n 20000 [--cpu] [--vs-batch]
      [--phy /tmp/big.phy --c /tmp/ccphylo_oracle/ccphylo]
      [--newick-out /tmp/ours.nwck]
"""

import argparse
import hashlib
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


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def run_packed(n, mod, kbatch):
    import jax.numpy as jnp
    from benchmarks.synth import device_words
    from ccphylo_tpu.tree.packed_engine import (dnj_joins_packed,
                                                limbs_host)
    t0 = time.perf_counter()
    words = device_words(n, mod=mod)
    import jax
    jax.block_until_ready(words)
    t1 = time.perf_counter()
    I, J, DIJ2, SDI2, SDJ2, dl2, _ = dnj_joins_packed(
        words, jnp.int32(n), kbatch=kbatch)
    k = n - 2
    rec = (np.asarray(I)[:k], np.asarray(J)[:k],
           np.asarray(DIJ2)[:k], np.asarray(SDI2)[:k],
           np.asarray(SDJ2)[:k])
    t2 = time.perf_counter()
    LI, LJ = limbs_host(I, J, DIJ2, SDI2, SDJ2, n, 1.0)
    print(f"gen {t1 - t0:.1f}s  joins {t2 - t1:.1f}s "
          f"({k / max(t2 - t1, 1e-9):,.0f} joins/s)  "
          f"records sha {digest(*rec)}", flush=True)
    st = getattr(dnj_joins_packed, "last_stats", None)
    if st is not None and k:
        print(f"stats: {st[0] / k:.2f} scan passes/join, "
              f"{st[1] / k:.1f} reval rows/join, "
              f"{st[2] / k:.1f} batch rows/join", flush=True)
    return rec, LI, LJ, int(np.asarray(dl2))


def _gen_mmap_fast(path, n, npad, mod, lo=3, data="hash"):
    """Disk memmap of the synth matrix via the native generator
    (benchmarks/synth_gen.c) — the numpy formulation streams ~8
    full-matrix temporaries through this box's 2 cores (hours at
    n=200k); the C writer does it at disk speed.  A file of the right
    size is REUSED after spot-verifying 512 random cells against
    cell_hash_np, so an interrupted engine run never pays gen twice."""
    import subprocess
    from benchmarks.synth import cell_hash_np, cell_metric_np
    cell = cell_metric_np if data == "metric" else cell_hash_np
    want = npad * npad
    rng = np.random.default_rng(0)
    ri = rng.integers(0, n, 512).astype(np.uint32)
    rj = rng.integers(0, n, 512).astype(np.uint32)
    if os.path.exists(path) and os.path.getsize(path) == want:
        Dq = np.memmap(path, np.uint8, "r+", shape=(npad, npad))
        if np.array_equal(Dq[ri, rj], cell(ri, rj, mod)):
            print("gen: reusing existing memmap", flush=True)
            return Dq
        del Dq
    binp = os.path.join("/tmp", "ccphylo_synth_gen")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "synth_gen.c")
    if (not os.path.exists(binp)
            or os.path.getmtime(binp) < os.path.getmtime(src)):
        subprocess.run(["gcc", "-O3", "-march=native", "-o", binp, src,
                        "-lpthread"], check=True)
    subprocess.run([binp, path, str(n), str(npad), str(mod), str(lo),
                    str(os.cpu_count() or 1), data], check=True)
    Dq = np.memmap(path, np.uint8, "r+", shape=(npad, npad))
    assert np.array_equal(Dq[ri, rj], cell(ri, rj, mod)), \
        "native generator does not match the synth cell fn"
    return Dq


def run_streamed(n, mod, kbatch, X, F, mmap_path=None,
                 data="hash"):
    """Beyond-device-memory engine: canonical matrix host-side (RAM or
    disk memmap), the device holds the X-row cache."""
    import resource
    from ccphylo_tpu.tree.packed_engine import limbs_host
    from ccphylo_tpu.tree.streamed_engine import (_pad512,
                                                  dnj_joins_streamed)
    from benchmarks.synth import cell_hash_np, cell_metric_np
    cell = cell_metric_np if data == "metric" else cell_hash_np
    npad = _pad512(n)
    t0 = time.perf_counter()
    if mmap_path:
        Dq = _gen_mmap_fast(mmap_path, n, npad, mod, data=data)
    else:
        Dq = np.empty((npad, npad), np.uint8)
        ch = 4096
        cols = np.arange(npad, dtype=np.uint32)
        for r0 in range(0, npad, ch):
            r1 = min(r0 + ch, npad)
            rows = np.arange(r0, r1, dtype=np.uint32)
            blk = cell(rows[:, None], cols[None, :], mod)
            if r1 > n:
                blk[max(n - r0, 0):, :] = 0
            blk[:, n:] = 0
            Dq[r0:r1] = blk
    t1 = time.perf_counter()
    print(f"gen {t1 - t0:.1f}s ({Dq.nbytes / 1e9:.1f} GB host"
          f"{' memmap' if mmap_path else ''})", flush=True)
    I, J, DIJ2, SDI2, SDJ2, dl2 = dnj_joins_streamed(
        Dq, n, X=X, F=F, kbatch=kbatch, verbose=True)
    t2 = time.perf_counter()
    eng = dnj_joins_streamed.last
    k = n - 2
    rec = (np.asarray(I)[:k], np.asarray(J)[:k],
           np.asarray(DIJ2)[:k], np.asarray(SDI2)[:k],
           np.asarray(SDJ2)[:k])
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    hbm = (X + F) * npad / 1e9
    print(f"streamed joins {t2 - t1:.1f}s "
          f"({k / max(t2 - t1, 1e-9):,.0f} joins/s)  "
          f"records sha {digest(*rec)}\n"
          f"aborts {eng.aborts}  uploaded rows {eng.uploaded_rows} "
          f"({eng.uploaded_rows * npad / 1e9:.2f} GB)  "
          f"scan passes/join {eng.stats[0] / max(k, 1):.2f}\n"
          f"matrix {Dq.nbytes / 1e9:.1f} GB host-side; "
          f"device cache+ring {hbm:.1f} GB; peak RSS {rss:.1f} GB",
          flush=True)
    LI, LJ = limbs_host(I, J, DIJ2, SDI2, SDJ2, n, 1.0)
    return rec, LI, LJ, int(dl2)


def newick_from(n, rec, LI, LJ, dl2):
    from ccphylo_tpu.io.qseqs import Name
    from ccphylo_tpu.tree.jax_engine import _records_to_newick
    k = n - 2
    # Name capacities must evolve exactly like the Phylip loader's
    # (formTree pre-allocates 32 cap-4 names, loadPhy extends with
    # cap-32; each name read grows for len+1 chars, phy.c:370-429) —
    # formNode picks child ORDER by buffer capacity (nwck.c:45-50), so
    # wrong caps flip children even with identical join records.
    names = []
    for i in range(n):
        nm = Name(b"", 4 if i < 32 else 32)
        nm.grow_for(9)  # "T%07d" = 8 chars + terminating separator
        nm.data = b"T%07d" % i
        names.append(nm)
    LI_f = np.zeros(n, np.float64)
    LJ_f = np.zeros(n, np.float64)
    LI_f[:k] = LI
    LJ_f[:k] = LJ
    return _records_to_newick(rec[0], rec[1], LI_f, LJ_f,
                              dl2 / 2.0, n, names, 0, 9)


def vs_batch(n, mod, rec):
    """Unpacked quantized engine, f64 compute (exact on half-integer
    values)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from benchmarks.synth import cell_hash_np
    from ccphylo_tpu.tree.jax_engine import dnj_joins_q, _pad
    npad = _pad(n)
    ii, jj = np.meshgrid(np.arange(npad, dtype=np.uint32),
                         np.arange(npad, dtype=np.uint32),
                         indexing="ij")
    Dq = cell_hash_np(ii, jj, mod)
    Dq[n:, :] = 0
    Dq[:, n:] = 0
    t0 = time.perf_counter()
    I, J, LI, LJ, dl, _ = dnj_joins_q(
        jnp.asarray(Dq), jnp.int32(n), jnp.asarray(1.0, jnp.float64),
        store_dtype=jnp.uint8, compute_dtype=jnp.float64)
    k = n - 2
    print(f"batch-f64 joins {time.perf_counter() - t0:.1f}s", flush=True)
    same_i = np.array_equal(np.asarray(I)[:k], rec[0])
    same_j = np.array_equal(np.asarray(J)[:k], rec[1])
    print(f"records vs batch-f64: I {'OK' if same_i else 'MISMATCH'} "
          f"J {'OK' if same_j else 'MISMATCH'}", flush=True)
    if not (same_i and same_j):
        bad = np.nonzero((np.asarray(I)[:k] != rec[0])
                         | (np.asarray(J)[:k] != rec[1]))[0]
        print(f"first divergence at join {bad[0]} of {k}", flush=True)
        return False
    return True


def host_records(n, mod):
    """Join records from the host numpy exact engine (tree/exact.py) —
    the oracle-anchored byte-parity engine — on the synthetic matrix."""
    from benchmarks.synth import cell_hash_np
    from ccphylo_tpu.tree import exact as ex
    iu = np.tril_indices(n, -1)
    flat = cell_hash_np(iu[0].astype(np.uint32),
                        iu[1].astype(np.uint32), mod).astype(np.float64)
    st = ex.TreeState(flat, n, "b", 1.0)
    cfg = ex.METHODS["dnj"]
    cfg["init"](st)
    qpair, update, pop = cfg["qpair"], cfg["update"], cfg["pop"]
    mi0, _ = ex.min_q(st)
    j = mi0
    I, J = [], []
    t0 = time.perf_counter()
    while st.n != 2:
        i, j2 = qpair(st, j)
        if i == 0 and j2 == 0:
            break
        I.append(i)
        J.append(j2)
        Li, Lj = ex.limb_length(i, j2, st.sD, st.N,
                                ex._d_ij(st, i, j2), False)
        mi = update(st, i, j2, Li, Lj)
        mj = pop(st, i)
        if mj == st.n:
            j = mi
        elif mi == st.n:
            j = mj
        else:
            j = ex.min_pos(st.Q, mi, mj)
        if len(I) % 2000 == 0:
            print(f"  host join {len(I)}/{n - 2} "
                  f"({len(I) / (time.perf_counter() - t0):,.0f}/s)",
                  flush=True)
    return np.array(I, np.int32), np.array(J, np.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["gen", "run", "hostcmp"])
    ap.add_argument("-n", type=int, default=20000)
    ap.add_argument("--mod", type=int, default=97)
    ap.add_argument("--phy", default=None)
    ap.add_argument("--c", default=None, help="reference binary path")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--kbatch", type=int, default=128)
    ap.add_argument("--engine", choices=["packed", "streamed"],
                    default="packed")
    ap.add_argument("--X", type=int, default=49152,
                    help="streamed: cache rows in device memory")
    ap.add_argument("--F", type=int, default=2048,
                    help="streamed: column-patch ring entries")
    ap.add_argument("--mmap", default=None,
                    help="streamed: back the host matrix with a disk "
                         "memmap at this path (the matrix.c mmap "
                         "analog) instead of RAM")
    ap.add_argument("--vs-batch", action="store_true")
    ap.add_argument("--newick-out", default=None)
    ap.add_argument("--c-nwck", default=None,
                    help="pre-computed reference Newick to compare "
                         "against (skips re-running the C binary)")
    ap.add_argument("--records-out", default=None)
    ap.add_argument("--records-in", default=None)
    ap.add_argument("--data", choices=["hash", "metric"],
                    default="hash",
                    help="synth family: tie-dense hash (adversarial) or clustered metric (phylogeny-like)")
    args = ap.parse_args()

    if args.mode == "gen":
        from benchmarks.synth import write_phy
        t0 = time.perf_counter()
        write_phy(args.phy, args.n, mod=args.mod, progress=True)
        print(f"wrote {args.phy} in {time.perf_counter() - t0:.0f}s")
        return

    if args.mode == "hostcmp":
        os.environ["JAX_PLATFORMS"] = "cpu"
        I, J = host_records(args.n, args.mod)
        print(f"host records sha {digest(I, J)}", flush=True)
        if args.records_out:
            np.savez(args.records_out, I=I, J=J)
        if args.records_in:
            d = np.load(args.records_in)
            same = (np.array_equal(d["I"][:len(I)], I)
                    and np.array_equal(d["J"][:len(J)], J))
            print("RECORDS PARITY OK (host exact == packed)" if same
                  else "RECORDS MISMATCH")
            if not same:
                bad = np.nonzero((d["I"][:len(I)] != I)
                                 | (d["J"][:len(J)] != J))[0]
                print("first divergence at join", bad[0])
                sys.exit(1)
        return

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    if args.engine == "streamed":
        rec, LI, LJ, dl2 = run_streamed(args.n, args.mod, args.kbatch,
                                        args.X, args.F, args.mmap,
                                        data=args.data)
    else:
        rec, LI, LJ, dl2 = run_packed(args.n, args.mod, args.kbatch)
    if args.records_out:
        np.savez(args.records_out, I=rec[0], J=rec[1], DIJ2=rec[2],
                 SDI2=rec[3], SDJ2=rec[4])

    if args.vs_batch:
        ok = vs_batch(args.n, args.mod, rec)
        if not ok:
            sys.exit(1)

    nwck = newick_from(args.n, rec, LI, LJ, dl2) + b";\n"
    print(f"newick sha {hashlib.sha256(nwck).hexdigest()[:16]}",
          flush=True)
    if args.newick_out:
        with open(args.newick_out, "wb") as fh:
            fh.write(nwck)
    if args.c_nwck:
        cbytes = open(args.c_nwck, "rb").read()
        if cbytes == nwck:
            print(f"NEWICK PARITY OK vs reference at n={args.n}")
        else:
            print("NEWICK MISMATCH vs reference")
            for k in range(min(len(cbytes), len(nwck))):
                if cbytes[k] != nwck[k]:
                    print("first differing byte at", k,
                          cbytes[k - 40:k + 40], nwck[k - 40:k + 40])
                    break
            sys.exit(1)
    if args.c and args.phy:
        out = args.phy + ".c.nwck"
        t0 = time.perf_counter()
        r = subprocess.run([args.c, "tree", "-m", "dnj", "-b", "-t",
                            str(os.cpu_count()), "-i", args.phy,
                            "-o", out], capture_output=True)
        print(f"C dnj -b: {time.perf_counter() - t0:.1f}s\n"
              + r.stderr.decode(), flush=True)
        cbytes = open(out, "rb").read()
        if cbytes == nwck:
            print(f"NEWICK PARITY OK vs reference at n={args.n}")
        else:
            print("NEWICK MISMATCH vs reference")
            for k in range(min(len(cbytes), len(nwck))):
                if cbytes[k] != nwck[k]:
                    print("first differing byte at", k,
                          cbytes[k - 40:k + 40], nwck[k - 40:k + 40])
                    break
            sys.exit(1)


if __name__ == "__main__":
    main()
