#!/usr/bin/env python
"""Smoke test of the CLI's device paths on an NVIDIA GPU.

Drives `python -m ccphylo_tpu dist|tree` (and the packed/streamed DNJ
drivers in benchmarks/parity_chain.py) with the device switches, at
sizes users run, and checks every result exactly against the host
engines or the reference's recorded output.  Default phases, one GPU:

  1. fill parity   dist -f 17 and -f 19 -n on 256 isolates x 5 Mbp:
                   device fill (CCPHYLO_TPU_DIST=device) byte-equal to
                   the host run, .phy and .num
  2. fill n=1024   dist -f 19 -n on all 1024 isolates on the device;
                   16 seeded rows recomputed with ops/snp.py
  3. pipeline      dist -f 17 on 1024 isolates, then tree -m dnj and
                   -m upgma with CCPHYLO_TPU_ENGINE=device64 byte-equal
                   to the host engine; -m dnj with =device (float32)
                   ends with all 1024 leaves
  4. packed DNJ    n=20000 synthetic matrix, tree -m dnj -b with
                   CCPHYLO_TPU_ENGINE=packed; Newick sha256 equal to the
                   reference C's (benchmarks/evidence/README.md)
  5. streamed DNJ  n=8192 with 6144 resident rows; join records equal
                   the packed engine's

Options (each runs its own path and what it is compared with, and no
other phase):

  --four       CCPHYLO_TPU_ENGINE=sharded64 at n=8192 on a 1-D mesh
               over 4 GPUs: tree -m dnj byte-equal to the host engine's
               recorded digest, tree -m upgma byte-equal to the same
               engine on 1 GPU; sharded_snp_matrix equal to the
               single-GPU snp_matrix
  --full-tree  packed DNJ at n=100000 against the checked-in reference
               Newick benchmarks/evidence/parity100k.c.nwck.gz

This process never imports JAX: a JAX process reserves most of a GPU's
memory, so each phase's device work runs in one child at a time.  Data
is generated from fixed seeds under chip_smoke_data/ and removed at the
end.  Prints the GPU's name and power limit, per-step wall time, XLA
compile time (JAX_LOG_COMPILES) and device peak_bytes_in_use, and as
its last line {"ok": true, "device": {...}}.  Exits nonzero without
that line when a phase fails or no GPU is found.

Usage: python chip_smoke.py [--four | --full-tree] [--keep-data]
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "chip_smoke_data"

N_ISOLATES, GENOME_LEN = 1024, 5_000_000
N_PARITY = 256
N_PACKED, NWCK20K_SHA256 = 20000, (
    "48baa6a297644bed0108931d3b97a863c6020b779990341eaa2ea51a9a64f0bc")
N_STREAMED, X_STREAMED = 8192, 6144
N_FOUR = 8192
# sha256 of the host exact engine's Newick (`python -m ccphylo_tpu tree
# -m dnj`, no device variables) on four_matrix(N_FOUR); the host dnj
# takes minutes at this n, so its digest is recorded, not rerun
FOUR_HOST_DNJ_SHA256 = (
    "9d198c716a9937f502742ead7c11e75149e88fc93e2f250173ca79bb44b1efe0")
STEP_TIMEOUT = 1100

# Runs `-m module args...`, `-c code` or `script.py args...` like the
# interpreter would, and reports each local device's peak_bytes_in_use
# when it ends (before exit: JAX's own exit handlers release the
# devices and reset their statistics).
_HOOK = r"""
import runpy, sys
def _report():
    jax = sys.modules.get("jax")
    if jax is not None:
        for d in jax.local_devices():
            st = d.memory_stats() or {}
            sys.stderr.write("chip_smoke peak_bytes_in_use %d\n"
                             % st.get("peak_bytes_in_use", -1))
try:
    if sys.argv[1] == "-m":
        sys.argv = sys.argv[2:]
        runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
    elif sys.argv[1] == "-c":
        code, sys.argv = sys.argv[2], ["-c"] + sys.argv[3:]
        exec(compile(code, "<string>", "exec"), {"__name__": "__main__"})
    else:
        sys.argv = sys.argv[1:]
        runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    _report()
"""


class PhaseError(RuntimeError):
    pass


def _env(extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CCPHYLO_TPU_")}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cuda",
               JAX_LOG_COMPILES="1")
    env.update(extra or {})
    return env


def run(label, argv, extra=None, device=True, stdout=None):
    """Run one child from DATA; returns its stdout bytes (or writes it
    to the file `stdout`).  Raises PhaseError on a nonzero exit."""
    cmd = [sys.executable] + (["-c", _HOOK] if device else []) + argv
    fo = open(DATA / stdout, "wb") if stdout else subprocess.PIPE
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=DATA, env=_env(extra),
                             timeout=STEP_TIMEOUT, stdout=fo,
                             stderr=subprocess.PIPE)
    finally:
        if stdout:
            fo.close()
    wall = time.perf_counter() - t0
    err = res.stderr
    (DATA / (re.sub(r"\W+", "_", label) + ".stderr")).write_bytes(err)
    if res.returncode != 0:
        raise PhaseError(f"{label}: exit {res.returncode}\n"
                         + err.decode(errors="replace")[-3000:])
    comp = [float(x) for x in re.findall(
        rb"Finished XLA compilation of .* in ([0-9.e+-]+) sec", err)]
    peaks = [int(x) for x in re.findall(
        rb"chip_smoke peak_bytes_in_use (-?\d+)", err)]
    line = f"  {label}: wall {wall:.2f} s"
    if device:
        line += (f", compile {sum(comp):.2f} s over {len(comp)} "
                 f"programs, peak_bytes_in_use "
                 f"{max(peaks) if peaks else 'n/a'}")
    print(line, flush=True)
    STEPS.append({"step": label, "wall_s": round(wall, 3),
                  "compile_s": round(sum(comp), 3) if device else None,
                  "peak_bytes": max(peaks) if peaks else None})
    return res.stdout


STEPS: list[dict] = []


def cli(*args):
    return ["-m", "ccphylo_tpu", *args]


def same_file(a, b, what):
    if (DATA / a).read_bytes() != (DATA / b).read_bytes():
        raise PhaseError(f"{what}: {a} != {b}")


def read_phy(name):
    """Lower-triangular Phylip text -> (names, rows of float cells)."""
    lines = (DATA / name).read_bytes().splitlines()
    n = int(lines[0])
    names, rows = [], []
    for ln in lines[1:n + 1]:
        parts = ln.split(b"\t")
        names.append(parts[0])
        rows.append([float(x) for x in parts[1:]])
    return names, rows


# ---------------------------------------------------------------------
# phases


def phase_fill_parity(files):
    sub = files[:N_PARITY]
    for f in ("17", "19"):
        for side, extra in (("host", None),
                            ("device", {"CCPHYLO_TPU_DIST": "device"})):
            args = ["dist", "-r", "tpl", "-f", f, "-o", f"p1_{side}.phy"]
            if f == "19":
                args += ["-n", f"p1_{side}.num"]
            run(f"dist -f {f} n={N_PARITY} {side}",
                cli(*args, "-i", *sub), extra, device=extra is not None)
        same_file("p1_host.phy", "p1_device.phy", f"dist -f {f} .phy")
        if f == "19":
            same_file("p1_host.num", "p1_device.num", "dist -f 19 .num")


def phase_fill_1024(files):
    from concurrent.futures import ThreadPoolExecutor
    from contextlib import redirect_stderr

    import numpy as np

    from ccphylo_tpu.cli.dist_cmd import _fsa_load_samples
    from ccphylo_tpu.ops import snp

    run(f"dist -f 19 n={len(files)} device",
        cli("dist", "-r", "tpl", "-f", "19", "-o", "p2.phy", "-n",
            "p2.num", "-i", *files), {"CCPHYLO_TPU_DIST": "device"})
    _, D = read_phy("p2.phy")
    _, N = read_phy("p2.num")
    if len(D) != len(files):
        raise PhaseError(f"p2.phy has {len(D)} rows, want {len(files)}")
    cfg = dict(flag=19, methfilename=None, min_length=1, proxi=0,
               incvariant="default", min_cov=0.5)
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(DATA)
    try:
        with open(os.devnull, "w") as dn, redirect_stderr(dn):
            seqs, incs, _, _, min_len, include = _fsa_load_samples(
                files, b"tpl", [1] * len(files), cfg)
    finally:
        os.chdir(cwd)
    if not all(include):
        raise PhaseError("an isolate was excluded; rows cannot align")
    rows = sorted(np.random.default_rng(16).choice(len(files), 16,
                                                   replace=False))

    def row_bad(i):
        bad = 0
        for j in range(len(files)):
            if i == j:
                continue
            # pair mask = AND of both masks (proxi 0, fsacmpthrd.c:409)
            d, inc = snp.fsacmpair(seqs[i], seqs[j], incs[i] & incs[j])
            a, b = max(i, j), min(i, j)
            want_d = float(d) if min_len <= inc else -1.0
            bad += D[a][b] != want_d or N[a][b] != float(inc)
        return bad

    with ThreadPoolExecutor(len(rows)) as pool:
        bad = sum(pool.map(row_bad, rows))
    print(f"  host recompute of rows {list(map(int, rows))}: "
          f"{time.perf_counter() - t0:.2f} s, {bad} cells differ",
          flush=True)
    if bad:
        raise PhaseError(f"dist -f 19 n={len(files)}: {bad} cells differ")


def phase_pipeline(files):
    run(f"dist -f 17 n={len(files)} device",
        cli("dist", "-r", "tpl", "-f", "17", "-o", "p3.phy", "-i", *files),
        {"CCPHYLO_TPU_DIST": "device"})
    for m in ("dnj", "upgma"):
        host = run(f"tree -m {m} n={len(files)} host",
                   cli("tree", "-m", m, "-i", "p3.phy"), device=False)
        dev = run(f"tree -m {m} n={len(files)} device64",
                  cli("tree", "-m", m, "-i", "p3.phy"),
                  {"CCPHYLO_TPU_ENGINE": "device64"})
        if dev != host:
            raise PhaseError(f"tree -m {m} device64 != host")
    dev = run(f"tree -m dnj n={len(files)} device (float32)",
              cli("tree", "-m", "dnj", "-i", "p3.phy"),
              {"CCPHYLO_TPU_ENGINE": "device"})
    names, _ = read_phy("p3.phy")
    leaves = re.findall(rb"[(,]([^(),:;]+):", dev)
    if not dev.endswith(b";\n") or sorted(leaves) != sorted(names):
        raise PhaseError(f"float32 dnj tree has {len(leaves)} leaves, "
                         f"want {len(names)}")


def phase_packed():
    chain = str(ROOT / "benchmarks" / "parity_chain.py")
    run(f"write n={N_PACKED} phy", [chain, "gen", "-n", str(N_PACKED),
                                    "--phy", "p4.phy"], device=False)
    out = run(f"tree -m dnj -b n={N_PACKED} packed",
              cli("tree", "-m", "dnj", "-b", "-i", "p4.phy"),
              {"CCPHYLO_TPU_ENGINE": "packed"})
    sha = hashlib.sha256(out).hexdigest()
    if sha != NWCK20K_SHA256:
        raise PhaseError(f"n={N_PACKED} Newick sha256 {sha} != reference")
    print(f"  n={N_PACKED} Newick sha256 == reference C {sha[:16]}",
          flush=True)


def phase_streamed():
    import numpy as np
    chain = str(ROOT / "benchmarks" / "parity_chain.py")
    for eng, extra in (("packed", []),
                       ("streamed", ["--X", str(X_STREAMED)])):
        run(f"{eng} DNJ n={N_STREAMED}",
            [chain, "run", "-n", str(N_STREAMED), "--engine", eng, *extra,
             "--records-out", f"p5_{eng}.npz"], stdout=f"p5_{eng}.txt")
    a = np.load(DATA / "p5_packed.npz")
    b = np.load(DATA / "p5_streamed.npz")
    for k in ("I", "J", "DIJ2", "SDI2", "SDJ2"):
        if not np.array_equal(a[k], b[k]):
            raise PhaseError(f"streamed records {k} != packed")
    print("  " + (DATA / "p5_streamed.txt").read_text().splitlines()[-4],
          flush=True)


def phase_full_tree():
    chain = str(ROOT / "benchmarks" / "parity_chain.py")
    ref = ROOT / "benchmarks" / "evidence" / "parity100k.c.nwck.gz"
    (DATA / "c100k.nwck").write_bytes(gzip.decompress(ref.read_bytes()))
    out = run("packed DNJ n=100000", [chain, "run", "-n", "100000",
                                      "--c-nwck", "c100k.nwck"])
    print("  " + "\n  ".join(out.decode().splitlines()[-4:]), flush=True)
    if b"NEWICK PARITY OK" not in out:
        raise PhaseError("n=100000 Newick differs from the reference")


def four_matrix(n):
    """Seeded integer distance matrix as Phylip bytes."""
    import io

    import numpy as np

    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    rng = np.random.RandomState(n)
    flat = rng.randint(0, 500, n * (n - 1) // 2).astype(np.float64)
    buf = io.BytesIO()
    print_phy(buf, n, flat, [Name(b"t%05d" % i, 32) for i in range(n)])
    return buf.getvalue()


_SHARDED_FILL = r"""
import jax, numpy as np
from ccphylo_tpu.utils.jaxconfig import configure_jax
configure_jax()
from ccphylo_tpu.ops import snp_jax
from ccphylo_tpu.parallel.multihost import row_mesh
mesh = row_mesh()
assert mesh.devices.size == 4, mesh
rng = np.random.default_rng(4)
n, W = 1024, 62500
s = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
pm = snp_jax.inc32_to_pairmask(
    rng.integers(0, 2 ** 32, W // 2, dtype=np.uint32))
a = snp_jax.sharded_snp_matrix(s, pm, mesh)
b = np.asarray(snp_jax.snp_matrix(s, pm))
assert np.array_equal(a, b), "sharded_snp_matrix != snp_matrix"
print("sharded_snp_matrix == snp_matrix at n=%d, L=%d" % (n, 16 * W))
"""


def phase_four():
    (DATA / "p4x.phy").write_bytes(four_matrix(N_FOUR))
    args = cli("tree", "-m", "dnj", "-i", "p4x.phy")
    out = run(f"tree -m dnj n={N_FOUR} sharded64, 4 GPUs", args,
              {"CCPHYLO_TPU_ENGINE": "sharded64"})
    sha = hashlib.sha256(out).hexdigest()
    if sha != FOUR_HOST_DNJ_SHA256:
        raise PhaseError(f"sharded dnj sha256 {sha} != host engine")
    # the sharded nj/upgma engine breaks ties first-wins and orders
    # children by slot (parallel/sharded_nj.py), so its bytes are not
    # the host's; it is held to device-count invariance instead
    args = cli("tree", "-m", "upgma", "-i", "p4x.phy")
    four = run(f"tree -m upgma n={N_FOUR} sharded64, 4 GPUs", args,
               {"CCPHYLO_TPU_ENGINE": "sharded64"})
    one = run(f"tree -m upgma n={N_FOUR} sharded64, 1 GPU", args,
              {"CCPHYLO_TPU_ENGINE": "sharded64",
               "CUDA_VISIBLE_DEVICES": "0"})
    if four != one:
        raise PhaseError("sharded upgma on 4 GPUs != on 1 GPU")
    out = run("sharded_snp_matrix vs snp_matrix", ["-c", _SHARDED_FILL])
    print("  " + out.decode().strip(), flush=True)


# ---------------------------------------------------------------------


def probe(want):
    """The device as JAX reports it, from a child process."""
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d)}))")
    res = subprocess.run([sys.executable, "-c", code], env=_env(None),
                         capture_output=True, timeout=300)
    if res.returncode != 0:
        raise PhaseError("JAX finds no GPU:\n"
                         + res.stderr.decode(errors="replace")[-2000:])
    dev = json.loads(res.stdout.decode().strip().splitlines()[-1])
    if dev["platform"] != "gpu" or dev["count"] < want:
        raise PhaseError(f"need {want} GPU(s), JAX reports {dev}")
    return dev


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--four", action="store_true")
    g.add_argument("--full-tree", action="store_true")
    ap.add_argument("--keep-data", action="store_true",
                    help="leave chip_smoke_data/ in place")
    args = ap.parse_args()

    if not (ROOT / "ccphylo_tpu" / "cli" / "main.py").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    smi = shutil.which("nvidia-smi")
    if smi is None:
        print("no NVIDIA GPU: nvidia-smi not found", file=sys.stderr)
        return 1
    q = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if q.returncode != 0:
        print("nvidia-smi failed:\n" + q.stderr, file=sys.stderr)
        return 1
    print(q.stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    from ccphylo_tpu import native
    print(f"native host library loaded: {native.available()}", flush=True)

    t_all = time.perf_counter()
    DATA.mkdir(exist_ok=True)
    try:
        dev = probe(4 if args.four else 1)
        if args.four:
            phases = [("four", phase_four)]
        elif args.full_tree:
            phases = [("full tree", phase_full_tree)]
        else:
            sys.path.insert(0, str(ROOT / "benchmarks"))
            from bench_e2e import gen_dataset
            t0 = time.perf_counter()
            files = gen_dataset(str(DATA), N_ISOLATES, GENOME_LEN,
                                seed=0, gz=False)
            print(f"generated {N_ISOLATES} isolates x {GENOME_LEN} bases "
                  f"in {time.perf_counter() - t0:.2f} s", flush=True)
            phases = [("1 fill parity", lambda: phase_fill_parity(files)),
                      ("2 fill n=1024", lambda: phase_fill_1024(files)),
                      ("3 pipeline", lambda: phase_pipeline(files)),
                      ("4 packed DNJ", phase_packed),
                      ("5 streamed DNJ", phase_streamed)]
        for name, fn in phases:
            print(f"phase {name}", flush=True)
            t0 = time.perf_counter()
            fn()
            print(f"phase {name}: ok, wall {time.perf_counter() - t0:.2f} s",
                  flush=True)
    except (PhaseError, subprocess.TimeoutExpired, OSError) as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if not args.keep_data:
            shutil.rmtree(DATA, ignore_errors=True)
    comp = sum(s["compile_s"] or 0.0 for s in STEPS)
    print(f"total wall {time.perf_counter() - t_all:.2f} s, "
          f"compile {comp:.2f} s", flush=True)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
