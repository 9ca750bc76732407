"""Multi-host runtime setup (jax.distributed) + mesh construction.

The reference is strictly single-node (pthreads over shared memory,
SURVEY.md §2.7); multi-host execution is new capability.  All engines
in this package (parallel/sharded_nj.py, parallel/sharded_dnj.py,
ops/snp_jax.sharded_snp_matrix) are written against a 1-D
`jax.sharding.Mesh` over row blocks, so the same compiled program runs
on one device, on the GPUs of one host (NVLink), or across hosts —
GSPMD places the collectives.

Environment-driven init (for launchers like GKE/JobSet or manual
mpirun-style starts):

  CCPHYLO_TPU_COORDINATOR  host:port of process 0
  CCPHYLO_TPU_NUM_PROCS    total process count
  CCPHYLO_TPU_PROC_ID      this process's index

Set CCPHYLO_TPU_AUTO_DISTRIBUTED=1 on a cluster whose launcher
jax.distributed can auto-detect (e.g. SLURM).
"""

from __future__ import annotations

import os

import numpy as np


def maybe_init_distributed() -> bool:
    """Initialize jax.distributed when a multi-process env is declared.

    Returns True when running multi-process.  Safe to call more than
    once; silently a no-op for single-process runs.
    """
    import jax

    coord = os.environ.get("CCPHYLO_TPU_COORDINATOR")
    nproc = os.environ.get("CCPHYLO_TPU_NUM_PROCS")
    pid = os.environ.get("CCPHYLO_TPU_PROC_ID")
    try:
        if coord and nproc and pid:
            jax.distributed.initialize(coordinator_address=coord,
                                       num_processes=int(nproc),
                                       process_id=int(pid))
        elif os.environ.get("CCPHYLO_TPU_AUTO_DISTRIBUTED"):
            jax.distributed.initialize()  # cloud auto-detection
        else:
            return False
    except RuntimeError as exc:
        # only a repeated call is benign; a genuine init failure must
        # not silently degrade an N-process job to N separate runs
        if "already initialized" not in str(exc).lower():
            raise
    return jax.process_count() > 1


def row_mesh(axis: str = "d"):
    """A 1-D mesh over every addressable device (all hosts)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))
