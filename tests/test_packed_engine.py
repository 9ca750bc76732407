"""Single-buffer u32-packed exact-integer DNJ (tree/packed_engine.py).

The packed engine computes the whole join trajectory in int32 "u units"
(u = 1/(2*ByteScale)) — bit-exact on every backend by construction —
and returns integer observables from which the host replays limbLength
in float64.  It must therefore match the unpacked quantized engine
(tree/jax_engine.dnj_joins_q) under f64 compute bitwise (f64 on these
exact half-integer quantities is itself exact), and the host exact -b
engine's Newick bytes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ccphylo_tpu.io.qseqs import Name
from ccphylo_tpu.tree.exact import build_tree
from ccphylo_tpu.tree.jax_engine import dnj_joins_q, _pad
from ccphylo_tpu.tree.packed_engine import (_pad_packed,
                                            build_tree_jax_packed,
                                            dnj_joins_packed,
                                            limbs_host,
                                            pack_words)


def _random_q(rng, n, lo=0.1, hi=12.0, bs=16.0):
    flat = rng.uniform(lo, hi, n * (n - 1) // 2)
    qv = np.clip(np.floor(flat * bs + 0.5), 0, 255).astype(np.uint8)
    return flat, qv, bs


def _square(qv, n, npad):
    Dq = np.zeros((npad, npad), np.uint8)
    iu = np.tril_indices(n, -1)
    Dq[(iu[0], iu[1])] = qv
    Dq[(iu[1], iu[0])] = qv
    return Dq


@pytest.mark.parametrize("n", [100, 257, 600])
def test_packed_matches_unpacked_records(n):
    """Bit-identical join records + limbs vs dnj_joins_q under f64
    compute — integer-quantized data is tie-dense, so this checks every
    tie rule survives the packing and the integer reformulation."""
    rng = np.random.RandomState(n)
    _, qv, bs = _random_q(rng, n)

    npad_u = _pad(n)
    Dq_u = _square(qv, n, npad_u)
    Iu, Ju, LIu, LJu, dlu, _ = dnj_joins_q(
        jnp.asarray(Dq_u), jnp.int32(n), jnp.asarray(bs, jnp.float64),
        store_dtype=jnp.uint8, compute_dtype=jnp.float64)

    words = pack_words(_square(qv, n, _pad_packed(n)))
    Ip, Jp, DIJ2, SDI2, SDJ2, dl2, _ = dnj_joins_packed(
        words, jnp.int32(n))
    LIp, LJp = limbs_host(Ip, Jp, DIJ2, SDI2, SDJ2, n, bs)

    k = n - 2
    np.testing.assert_array_equal(np.asarray(Iu)[:k], np.asarray(Ip)[:k])
    np.testing.assert_array_equal(np.asarray(Ju)[:k], np.asarray(Jp)[:k])
    np.testing.assert_array_equal(np.asarray(LIu, np.float64)[:k],
                                  LIp[:k])
    np.testing.assert_array_equal(np.asarray(LJu, np.float64)[:k],
                                  LJp[:k])
    assert float(dlu) == float(np.asarray(dl2)) / (2.0 * bs)


@pytest.mark.parametrize("seed", range(3))
def test_packed_matches_exact_b(seed):
    """u8 packed integer engine reproduces the host exact -b engine's
    Newick bytes."""
    n = 48
    rng = np.random.RandomState(seed)
    flat = rng.uniform(0.1, 12.0, n * (n - 1) // 2)
    bs = 16.0
    na = [Name(b"t%03d" % i, 32) for i in range(n)]
    nb_names = [Name(b"t%03d" % i, 32) for i in range(n)]
    exact = build_tree(flat.copy(), n, na, "dnj", dtype="b",
                       bytescale=bs)
    packed = build_tree_jax_packed(flat.copy(), n, nb_names,
                                   bytescale=bs)
    assert packed == exact


def test_packed_tiny_integer_ties():
    """Integer SNP-like matrix (ties everywhere): packed == unpacked."""
    rng = np.random.RandomState(7)
    n = 120
    qv = rng.randint(0, 6, n * (n - 1) // 2).astype(np.uint8)
    bs = 1.0
    npad_u = _pad(n)
    Iu, Ju, *_ = dnj_joins_q(
        jnp.asarray(_square(qv, n, npad_u)), jnp.int32(n),
        jnp.asarray(bs, jnp.float64), store_dtype=jnp.uint8,
        compute_dtype=jnp.float64)
    words = pack_words(_square(qv, n, _pad_packed(n)))
    Ip, Jp, *_ = dnj_joins_packed(words, jnp.int32(n))
    k = n - 2
    np.testing.assert_array_equal(np.asarray(Iu)[:k], np.asarray(Ip)[:k])
    np.testing.assert_array_equal(np.asarray(Ju)[:k], np.asarray(Jp)[:k])


def test_packed_kbatch_invariance():
    """The revalidation batch width is a performance knob only: join
    records are identical for any kbatch (the prefix-min gating
    recovers minQpair's exact revalidated set regardless of batching).
    """
    rng = np.random.RandomState(11)
    n = 300
    _, qv, bs = _random_q(rng, n)
    ref = None
    for kb in (32, 128, 512):
        words = pack_words(_square(qv, n, _pad_packed(n)))
        I, J, DIJ2, SDI2, SDJ2, dl2, _ = dnj_joins_packed(
            words, jnp.int32(n), kbatch=kb)
        rec = (np.asarray(I)[:n - 2].copy(),
               np.asarray(J)[:n - 2].copy(),
               np.asarray(SDI2)[:n - 2].copy())
        if ref is None:
            ref = rec
        else:
            for a, b in zip(ref, rec):
                np.testing.assert_array_equal(a, b)


def test_packed_newick_vs_host_exact_midsize():
    """Tie-dense n=1000 integer matrix: full Newick byte parity against
    the host exact -b engine (the oracle-anchored path)."""
    n = 1000
    rng = np.random.RandomState(3)
    flat = rng.randint(0, 40, n * (n - 1) // 2).astype(np.float64)
    na = [Name(b"t%04d" % i, 32) for i in range(n)]
    nb_names = [Name(b"t%04d" % i, 32) for i in range(n)]
    exact = build_tree(flat.copy(), n, na, "dnj", dtype="b",
                       bytescale=1.0)
    packed = build_tree_jax_packed(flat.copy(), n, nb_names,
                                   bytescale=1.0)
    assert packed == exact


def test_packed_checkpoint_resume(tmp_path, monkeypatch):
    """Kill-and-resume: a run killed after a mid-run checkpoint and
    restarted from the snapshot produces byte-identical records to an
    uninterrupted run (reference analog
    printphyUpdate resume, phy.c:201-249)."""
    import ccphylo_tpu.tree.packed_engine as pe

    n = 220
    rng = np.random.RandomState(5)
    qv = rng.randint(0, 30, n * (n - 1) // 2).astype(np.uint8)
    words0 = _square(qv, n, _pad_packed(n))

    def run(hooks=None):
        I, J, DIJ2, SDI2, SDJ2, dl2, _ = pe.dnj_joins_packed(
            pack_words(words0), jnp.int32(n), hooks=hooks)
        k = n - 2
        return (np.asarray(I)[:k].copy(), np.asarray(J)[:k].copy(),
                np.asarray(SDI2)[:k].copy(), int(np.asarray(dl2)))

    # uninterrupted reference
    ref = run()

    ck = str(tmp_path / "dnj.ckpt.npz")
    monkeypatch.setenv("CCPHYLO_TPU_CKPT", ck)
    monkeypatch.setenv("CCPHYLO_TPU_CKPT_EVERY_S", "0")  # every segment
    monkeypatch.setenv("CCPHYLO_TPU_SEG", "64")
    monkeypatch.setenv("CCPHYLO_TPU_SEG_FIXED", "1")

    class Killed(Exception):
        pass

    def killer(state, done, total):
        if done >= 64:
            raise Killed  # simulate a mid-run crash after a snapshot

    with pytest.raises(Killed):
        run(hooks=killer)
    assert np.load(ck)["meta"][0] >= 64  # snapshot exists mid-run

    # resume must NOT re-run init (it must restart from the snapshot)
    def no_init(*a, **kw):
        raise AssertionError("init re-ran on resume")
    monkeypatch.setattr(pe, "_packed_init", no_init)
    resumed = run()
    assert not (tmp_path / "dnj.ckpt.npz").exists()  # cleaned up
    for a, b in zip(ref, resumed):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
