"""Sharded DNJ vs the single-chip batch engine on a virtual device mesh.

On continuous random matrices (no exact Q ties) the sharded engine must
reproduce the single-chip scan="batch" join records exactly, for any
device count — the allreduce-argmin pick rule is device-count
invariant.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from ccphylo_tpu.io.qseqs import Name  # noqa: E402
from ccphylo_tpu.parallel.sharded_dnj import (  # noqa: E402
    build_tree_sharded_dnj, sharded_dnj_records)
from ccphylo_tpu.tree.jax_engine import build_tree_jax  # noqa: E402
from ccphylo_tpu.tree.exact import build_tree  # noqa: E402


def _mesh(k):
    devs = jax.devices()
    if len(devs) < k:
        pytest.skip(f"need {k} devices")
    return Mesh(np.array(devs[:k]), ("d",))


def _rand_flat(n, seed, missing=0.0):
    rng = np.random.RandomState(seed)
    flat = rng.uniform(0.01, 1.0, n * (n - 1) // 2)
    if missing:
        flat[rng.rand(len(flat)) < missing] = -1.0
    return flat


def _square(flat, n):
    D = np.full((n, n), -1.0, np.float64)
    iu = np.tril_indices(n, -1)
    D[(iu[0], iu[1])] = flat
    D[(iu[1], iu[0])] = flat
    np.fill_diagonal(D, 0.0)
    return D


@pytest.mark.parametrize("n,ndev,seed", [(37, 2, 0), (64, 4, 1),
                                         (130, 8, 2), (200, 8, 3)])
def test_sharded_matches_batch_engine(n, ndev, seed):
    mesh = _mesh(ndev)
    flat = _rand_flat(n, seed)
    D = _square(flat, n)
    I, J, LI, LJ, dl = sharded_dnj_records(D, n, mesh, dtype=jnp.float64)

    from ccphylo_tpu.tree.jax_engine import dnj_joins, _pad
    npad = _pad(n)
    Dp = np.full((npad, npad), -1.0, np.float64)
    Dp[:n, :n] = D
    I2, J2, LI2, LJ2, dl2, _ = (np.asarray(x) for x in dnj_joins(
        jnp.asarray(Dp, jnp.float64), jnp.int32(n), scan="batch"))

    np.testing.assert_array_equal(I[:n - 2], I2[:n - 2])
    np.testing.assert_array_equal(J[:n - 2], J2[:n - 2])
    np.testing.assert_allclose(LI[:n - 2], LI2[:n - 2], rtol=1e-12)
    np.testing.assert_allclose(LJ[:n - 2], LJ2[:n - 2], rtol=1e-12)
    assert float(dl) == pytest.approx(float(dl2), rel=1e-12)


def test_sharded_tree_matches_exact(seed=5, n=96):
    """End-to-end Newick equality vs the host exact engine on
    continuous data (unique Q minima all the way down)."""
    mesh = _mesh(4)
    flat = _rand_flat(n, seed)
    names = [Name(b"t%03d" % i, 32) for i in range(n)]
    nb = [Name(x.data, x.cap) for x in names]
    exact = build_tree(flat.copy(), n, names, "dnj")
    sharded = build_tree_sharded_dnj(flat.copy(), n, nb, mesh,
                                     dtype=jnp.float64)
    assert sharded == exact


def test_sharded_missing_data(seed=7, n=48):
    """Missing cells: per-pair N bookkeeping and update fallbacks
    must survive sharding (records equal the batch engine's)."""
    mesh = _mesh(4)
    flat = _rand_flat(n, seed, missing=0.15)
    D = _square(flat, n)
    I, J, LI, LJ, dl = sharded_dnj_records(D, n, mesh, dtype=jnp.float64)

    from ccphylo_tpu.tree.jax_engine import dnj_joins, _pad
    npad = _pad(n)
    Dp = np.full((npad, npad), -1.0, np.float64)
    Dp[:n, :n] = D
    I2, J2, LI2, LJ2, dl2, _ = (np.asarray(x) for x in dnj_joins(
        jnp.asarray(Dp, jnp.float64), jnp.int32(n), scan="batch"))
    np.testing.assert_array_equal(I[:n - 2], I2[:n - 2])
    np.testing.assert_array_equal(J[:n - 2], J2[:n - 2])


def test_device_count_invariance(n=80, seed=9):
    flat = _rand_flat(n, seed)
    D = _square(flat, n)
    recs = []
    for k in (2, 8):
        mesh = _mesh(k)
        recs.append(sharded_dnj_records(D, n, mesh, dtype=jnp.float64))
    np.testing.assert_array_equal(recs[0][0], recs[1][0])
    np.testing.assert_array_equal(recs[0][1], recs[1][1])


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_tie_exact_integer(ndev, n=160, seed=41):
    """Integer (tie-heavy) matrices: the sharded engine must reproduce
    the host exact engine's trajectory byte-for-byte — the
    global-descending batch threshold keeps the C's running-min gating
    exact across devices (sharded_dnj.py bbody)."""
    mesh = _mesh(ndev)
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, 25, n * (n - 1) // 2).astype(np.float64)
    names = [Name(b"t%03d" % i, 32) for i in range(n)]
    nb = [Name(x.data, x.cap) for x in names]
    exact = build_tree(flat.copy(), n, names, "dnj")
    sharded = build_tree_sharded_dnj(flat.copy(), n, nb, mesh,
                                     dtype=jnp.float64)
    assert sharded == exact


def test_device_count_invariance_4k(n=4096, seed=13):
    """Engine-relevant scale: tie-dense integer
    data at n=4096 — 8-device records must equal the single-chip batch
    engine's (the widest device-count gap; the reference's
    thread-count-independence guarantee, nj.c:492-510, at a size where
    batch passes, popArrange swaps and cross-pass thresholds all
    engage thousands of times).  The full 2-vs-8 sweep also passed at
    n=4096 (31 min; run deliberately kept to the two heaviest engines
    so the suite stays under ~35 min)."""
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, 97, n * (n - 1) // 2).astype(np.float64)
    D = _square(flat, n)
    mesh = _mesh(8)
    I, J, *_ = sharded_dnj_records(D, n, mesh, dtype=jnp.float64)

    from ccphylo_tpu.tree.jax_engine import dnj_joins, _pad
    npad = _pad(n)
    Dp = np.full((npad, npad), -1.0, np.float64)
    Dp[:n, :n] = D
    I2, J2, *_ = (np.asarray(x) for x in dnj_joins(
        jnp.asarray(Dp, jnp.float64), jnp.int32(n), scan="batch"))
    np.testing.assert_array_equal(I[:n - 2], I2[:n - 2])
    np.testing.assert_array_equal(J[:n - 2], J2[:n - 2])


def test_sharded_tie_exact_multipass(n=144, seed=3):
    """Force multi-pass revalidation (KBATCH=2) so joins where a
    device's candidate set exceeds one batch exercise the cross-pass
    ordering; the trajectory must stay C-exact."""
    import ccphylo_tpu.parallel.sharded_dnj as sd
    mesh = _mesh(8)
    old = sd.KBATCH
    sd._dnj_programs.cache_clear()
    sd.KBATCH = 2
    try:
        rng = np.random.RandomState(seed)
        flat = rng.randint(0, 20, n * (n - 1) // 2).astype(np.float64)
        names = [Name(b"t%03d" % i, 32) for i in range(n)]
        nb = [Name(x.data, x.cap) for x in names]
        exact = build_tree(flat.copy(), n, names, "dnj")
        sharded = build_tree_sharded_dnj(flat.copy(), n, nb, mesh,
                                         dtype=jnp.float64)
        assert sharded == exact
    finally:
        sd.KBATCH = old
        sd._dnj_programs.cache_clear()
