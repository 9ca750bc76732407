"""Tests for the aux subsystems: block checkpointing and phase timing."""

import json
import subprocess
import sys

import numpy as np
import pytest

from .conftest import REPO
from .gen_kma_data import make_dataset
from ccphylo_tpu.utils.checkpoint import BlockCheckpoint, fingerprint_arrays


def test_block_checkpoint_resume(tmp_path):
    n = 10
    rng = np.random.RandomState(0)
    M = rng.randint(0, 100, (n, n)).astype(np.int64)
    M = np.tril(M, -1)
    M = M + M.T

    calls = []

    def compute(si, sj):
        calls.append((si.start, sj.start))
        return M[si, sj]

    bc = BlockCheckpoint(str(tmp_path), n, "fp1", block=4)
    out = bc.fill(compute)
    np.testing.assert_array_equal(out, M)
    n_first = len(calls)
    assert n_first == 6  # 3x3 lower-triangular tile grid

    # resume: nothing recomputed
    bc2 = BlockCheckpoint(str(tmp_path), n, "fp1", block=4)
    out2 = bc2.fill(compute)
    np.testing.assert_array_equal(out2, M)
    assert len(calls) == n_first

    # changed fingerprint: full recompute
    bc3 = BlockCheckpoint(str(tmp_path), n, "fp2", block=4)
    bc3.fill(compute)
    assert len(calls) == 2 * n_first


def test_block_checkpoint_partial_resume(tmp_path):
    """A run killed mid-fill resumes from the finished tiles."""
    n = 8
    M = np.arange(64).reshape(8, 8).astype(np.int64)
    M = np.tril(M, -1) + np.tril(M, -1).T

    class Boom(Exception):
        pass

    state = {"count": 0}

    def flaky(si, sj):
        state["count"] += 1
        if state["count"] == 3:
            raise Boom()
        return M[si, sj]

    bc = BlockCheckpoint(str(tmp_path), n, "fp", block=3)
    with pytest.raises(Boom):
        bc.fill(flaky)

    def clean(si, sj):
        state["count"] += 1
        return M[si, sj]

    bc2 = BlockCheckpoint(str(tmp_path), n, "fp", block=3)
    out = bc2.fill(clean)
    np.testing.assert_array_equal(out, M)
    # 6 tiles total, 2 finished before the crash, 4 after
    assert state["count"] == 3 + 4


def test_fingerprint_sensitivity():
    a = np.arange(10, dtype=np.uint32)
    b = a.copy()
    assert fingerprint_arrays([a]) == fingerprint_arrays([b])
    b[3] ^= 1
    assert fingerprint_arrays([a]) != fingerprint_arrays([b])
    assert fingerprint_arrays([a]) != fingerprint_arrays(
        [a.astype(np.uint64)])


def test_dist_ckpt_env_byte_parity(tmp_path):
    """CCPHYLO_TPU_CKPT produces the same bytes and survives a resume."""
    d = tmp_path / "kma"
    d.mkdir()
    make_dataset(d, n_samples=5, length=300)
    import glob
    import os
    fsas = sorted(os.path.basename(p)
                  for p in glob.glob(str(d / "*.fsa.gz")))
    args = ["dist", "-r", "tpl1", "-f", "17", "-i"] + fsas

    def run(extra):
        env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
        env.update(extra)
        res = subprocess.run([sys.executable, "-m", "ccphylo_tpu"] + args,
                             capture_output=True, cwd=d, timeout=600,
                             env=env)
        assert res.returncode == 0, res.stderr.decode(errors="replace")
        return res.stdout

    plain = run({})
    ck = str(tmp_path / "ckpt")
    first = run({"CCPHYLO_TPU_CKPT": ck})
    resumed = run({"CCPHYLO_TPU_CKPT": ck})
    assert first == plain
    assert resumed == plain
    manifest = json.loads(
        (tmp_path / "ckpt" / "D.manifest.json").read_text())
    assert manifest["done"]


def test_profile_stderr(tmp_path):
    d = tmp_path / "kma"
    d.mkdir()
    make_dataset(d, n_samples=4, length=200)
    import glob
    import os
    fsas = sorted(os.path.basename(p)
                  for p in glob.glob(str(d / "*.fsa.gz")))
    res = subprocess.run(
        [sys.executable, "-m", "ccphylo_tpu", "dist", "-r", "tpl1",
         "-f", "17", "-i"] + fsas,
        capture_output=True, cwd=d, timeout=600,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "CCPHYLO_TPU_PROFILE": "stderr"})
    assert res.returncode == 0
    assert b"ccphylo_tpu profile" in res.stderr


@pytest.mark.parametrize("env_dir", [False, True])
def test_configure_jax_cache_dir(tmp_path, env_dir):
    """The compile cache goes to $JAX_COMPILATION_CACHE_DIR when it is
    set, and to <repo>/.jax_cache otherwise."""
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    want = str(REPO / ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("from ccphylo_tpu.utils.jaxconfig import configure_jax; "
            "print(configure_jax().config.jax_compilation_cache_dir)")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    assert res.stdout.decode().strip() == want
