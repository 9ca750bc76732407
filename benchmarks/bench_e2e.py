#!/usr/bin/env python
"""End-to-end `dist` + `tree` benchmark: reference C vs this framework
(host byte-parity engines and GPU device engines) on one synthetic
dataset.

Generates n samples of an L-base template with random SNPs (gzipped
fastas), then times:

  A. reference: ccphylo dist -f 17 … | ccphylo tree -m dnj  (64 thr)
  B. ours/host: byte-parity engines (must equal A byte-for-byte)
  C. ours/GPU:  CCPHYLO_TPU_DIST=device + CCPHYLO_TPU_ENGINE=device

Usage: python benchmarks/bench_e2e.py [-n 64] [-L 200000]
       [--ref /tmp/ccphylo_oracle/ccphylo]
"""

import argparse
import gzip
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def gen_dataset(d: str, n: int, L: int, seed: int = 0,
                gz: bool = True):
    """n samples of one random L-base template ("tpl"), each with
    L/500..L/100 random SNPs and up to L/200 Ns, as 70-column fasta
    files s000.fsa[.gz] in `d`.  Returns the file names."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    tmpl = bases[rng.integers(0, 4, L)]
    full = L // 70 * 70
    lines = np.empty((L // 70, 71), np.uint8)
    lines[:, 70] = ord("\n")
    names = []
    for i in range(n):
        seq = tmpl.copy()
        nsnp = int(rng.integers(L // 500, L // 100))
        seq[rng.integers(0, L, nsnp)] = bases[rng.integers(0, 4, nsnp)]
        seq[rng.integers(0, L, int(rng.integers(0, L // 200)))] = ord("N")
        lines[:, :70] = seq[:full].reshape(-1, 70)
        body = lines.tobytes()
        if L > full:
            body += seq[full:].tobytes() + b"\n"
        fn = os.path.join(d, f"s{i:03d}.fsa" + (".gz" if gz else ""))
        opener = (lambda f: gzip.open(f, "wb", compresslevel=1)) if gz \
            else (lambda f: open(f, "wb"))
        with opener(fn) as fh:
            fh.write(b">tpl\n" + body)
        names.append(os.path.basename(fn))
    return names


def run(cmd, cwd, env=None):
    e = {"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO}
    e.update(env or {})
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cwd, env=e, capture_output=True)
    dt = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr.decode(errors="replace")[-2000:]
    return dt, res.stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=64)
    ap.add_argument("-L", type=int, default=200_000)
    ap.add_argument("--ref", default="/tmp/ccphylo_oracle/ccphylo")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as d:
        names = gen_dataset(d, args.n, args.L)
        dist_args = ["dist", "-r", "tpl", "-f", "17", "-o", "D.phy",
                     "-i"] + names
        tree_args = ["tree", "-m", "dnj", "-i", "D.phy"]

        results = {}
        if os.path.exists(args.ref):
            threads = str(min(64, os.cpu_count() or 1))
            t1, _ = run([args.ref] + dist_args + ["-t", threads], d)
            t2, nwck = run([args.ref] + tree_args + ["-t", threads], d)
            results["A  reference C"] = (t1, t2, nwck)

        py = [sys.executable, "-m", "ccphylo_tpu"]
        t1, _ = run(py + dist_args, d)
        t2, nwck = run(py + tree_args, d)
        results["B  ours host "] = (t1, t2, nwck)

        # persistent process: device start-up and the XLA compile
        # cache are paid once, like a long-running service would
        os.environ["CCPHYLO_TPU_DIST"] = "device"
        os.environ["CCPHYLO_TPU_ENGINE"] = "device"
        from ccphylo_tpu.cli.dist_cmd import main_dist
        from ccphylo_tpu.cli.tree_cmd import main_tree
        from ccphylo_tpu.utils.jaxconfig import configure_jax
        cwd0 = os.getcwd()
        os.chdir(d)
        try:
            configure_jax()  # cache setup outside the timers
            t0 = time.perf_counter()
            main_dist(dist_args[1:])
            t1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            main_tree(tree_args[1:] + ["-o", "T_c.nwck"])
            t2 = time.perf_counter() - t0
        finally:
            os.chdir(cwd0)
        with open(os.path.join(d, "T_c.nwck"), "rb") as fh:
            dev_nwck = fh.read()
        results["C  ours GPU  "] = (t1, t2, dev_nwck)

        print(f"n={args.n} samples, L={args.L} bases")
        for k, (t1, t2, _) in results.items():
            print(f"{k}: dist {t1:6.2f}s  tree {t2:6.2f}s  "
                  f"total {t1 + t2:6.2f}s")
        if "A  reference C" in results:
            same = results["A  reference C"][2] == results["B  ours host "][2]
            print("host Newick == reference:", same)
            print("GPU Newick == reference:",
                  results["A  reference C"][2] == dev_nwck)


if __name__ == "__main__":
    main()
