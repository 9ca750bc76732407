#!/usr/bin/env python
"""Benchmark: all-pairs 2-bit SNP distance throughput on one GPU.

Prints the GPU's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

- value: sample-pairs/s of the device SNP fill (ops/snp_jax.snp_matrix,
  n=2048 samples, L=1M bases, shared include mask), the best of REPS
  warm calls, each timed to block_until_ready.
- vs_baseline: ratio against a freshly compiled multithreaded C
  XOR-popcount harness (an *optimized* stand-in for the reference's
  fsacmpair loop — it uses hardware popcount where the reference is
  bit-serial, so the ratio understates our advantage).

Exits nonzero when JAX finds no GPU: a CPU number is not a device
number.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SAMPLES = 2048
L_BASES = 1_000_000
REPS = 3

C_HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include <pthread.h>

static int NS, NW, NT;
static uint64_t *seqs;
static uint64_t *mask;
static volatile long long total;
static pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
static int cursor = 1;

static void *worker(void *arg) {
    long long acc = 0;
    for (;;) {
        pthread_mutex_lock(&mu);
        int i = cursor++;
        pthread_mutex_unlock(&mu);
        if (i >= NS) break;
        const uint64_t *a = seqs + (size_t)i * NW;
        for (int j = 0; j < i; ++j) {
            const uint64_t *b = seqs + (size_t)j * NW;
            long long d = 0;
            for (int w = 0; w < NW; ++w) {
                uint64_t x = a[w] ^ b[w];
                x = (x | (x >> 1)) & 0x5555555555555555ULL & mask[w];
                d += __builtin_popcountll(x);
            }
            acc += d;
        }
    }
    pthread_mutex_lock(&mu);
    total += acc;
    pthread_mutex_unlock(&mu);
    return NULL;
}

int main(int argc, char **argv) {
    NS = atoi(argv[1]);
    NW = atoi(argv[2]);
    NT = atoi(argv[3]);
    seqs = malloc((size_t)NS * NW * 8);
    mask = malloc((size_t)NW * 8);
    srand(7);
    for (size_t k = 0; k < (size_t)NS * NW; ++k)
        seqs[k] = ((uint64_t)rand() << 32) ^ rand();
    for (int w = 0; w < NW; ++w) mask[w] = 0x5555555555555555ULL;
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    pthread_t th[256];
    for (int t = 0; t < NT - 1; ++t) pthread_create(&th[t], 0, worker, 0);
    worker(0);
    for (int t = 0; t < NT - 1; ++t) pthread_join(th[t], 0);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    printf("%f %lld\n", dt, total);
    return 0;
}
"""


def measure_c_baseline(n, w64):
    try:
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "h.c")
            binp = os.path.join(td, "h")
            with open(src, "w") as fh:
                fh.write(C_HARNESS)
            subprocess.run(["gcc", "-O3", "-march=native", "-o", binp,
                            src, "-lpthread"], check=True,
                           capture_output=True, timeout=120)
            threads = min(64, os.cpu_count() or 1)
            out = subprocess.run([binp, str(n), str(w64), str(threads)],
                                 capture_output=True, timeout=560,
                                 check=True)
            dt = float(out.stdout.split()[0])
            pairs = n * (n - 1) // 2
            return pairs / dt, threads
    except Exception as exc:  # noqa: BLE001
        print(f"# baseline unavailable: {exc}", file=sys.stderr)
        return None


def main():
    import jax
    import jax.numpy as jnp
    from ccphylo_tpu.ops import snp_jax
    from ccphylo_tpu.utils.jaxconfig import configure_jax

    configure_jax()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX reports {dev.platform}", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    w32 = L_BASES // 16
    seqs = jax.random.bits(jax.random.PRNGKey(7), (N_SAMPLES, w32),
                           jnp.uint32)
    dm = jnp.full((w32,), 0x55555555, jnp.uint32)
    jax.block_until_ready(snp_jax.snp_matrix(seqs, dm))  # compile
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(snp_jax.snp_matrix(seqs, dm))
        best = min(best, time.perf_counter() - t0)
    pairs = N_SAMPLES * (N_SAMPLES - 1) // 2
    ours = pairs / best

    res = measure_c_baseline(min(N_SAMPLES, 256), L_BASES // 32)
    # C throughput is ~constant per pair at fixed L; measuring fewer
    # samples keeps the bench fast without changing the rate
    base, cthreads = res if res else (None, 0)
    vs = (ours / base) if base else 0.0
    print(json.dumps({
        "metric": "snp_pairwise_distances_per_s",
        "value": round(ours, 1),
        "unit": f"sample-pairs/s (n={N_SAMPLES}, L={L_BASES}); "
                f"baseline = {cthreads}-thread C hw-popcount harness "
                f"on the same host",
        "vs_baseline": round(vs, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
