"""qrow_mins (the packed DNJ engine's batch scan, tree/packed_engine.py)
vs an independent numpy evaluation of the same Q-row minima.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ccphylo_tpu.tree.packed_engine import qrow_mins  # noqa: E402

IBIG = 2 ** 31 - 1


def _reference(rows, co, words, sd2):
    """The packed engine's jnp formulation (packed_engine.py bbody)."""
    n, W = words.shape
    idx = np.arange(n, dtype=np.int32)
    r = np.asarray(rows, np.int64)
    cells = np.zeros((len(r), n), np.int64)
    w = np.asarray(words, np.uint64)[r]
    for b in range(4):
        cells[:, b::4] = (w >> (8 * b)) & 0xFF
    q = co * cells - np.asarray(sd2, np.int64)[r][:, None] \
        - np.asarray(sd2, np.int64)[None, :]
    ok = idx[None, :] < r[:, None]
    q = np.where(ok, q, IBIG)
    rmin = q.min(axis=1)
    rarg = np.where(q == rmin[:, None], idx[None, :], -1).max(axis=1)
    return rmin.astype(np.int32), np.maximum(rarg, 0).astype(np.int32)


def _run(rows, co, words, sd2):
    return qrow_mins(jnp.asarray(words), jnp.asarray(sd2, jnp.int32),
                     jnp.asarray(rows, jnp.int32), jnp.int32(co),
                     jnp.arange(words.shape[0], dtype=jnp.int32))


def test_qrow_mins_parity():
    rng = np.random.default_rng(7)
    n, K = 512, 16
    W = n // 4
    words = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    sd2 = rng.integers(0, 1 << 20, n, dtype=np.int32)
    rows = rng.integers(1, n, K, dtype=np.int32)
    co = 2 * (n - 2)
    rmin, rarg = _run(rows, co, words, sd2)
    emin, earg = _reference(rows, co, words, sd2)
    np.testing.assert_array_equal(np.asarray(rmin), emin)
    np.testing.assert_array_equal(np.asarray(rarg), earg)


def test_qrow_mins_ties_last_wins():
    """Identical cells + identical sd2 => every column ties; the
    engine's rule picks the LARGEST column index < r."""
    n, K = 512, 8
    W = n // 4
    words = np.full((n, W), 0x05050505, np.uint32)  # all cells = 5
    sd2 = np.zeros(n, np.int32)
    rows = np.asarray([1, 2, 3, 100, 255, 256, 511, 8], np.int32)
    co = 10
    rmin, rarg = _run(rows, co, words, sd2)
    np.testing.assert_array_equal(np.asarray(rarg), rows - 1)
    np.testing.assert_array_equal(np.asarray(rmin),
                                  np.full(K, 50, np.int32))


def test_qrow_mins_padding_rows():
    """Padding entries (row 0) produce garbage that callers mask; they
    must not corrupt valid lanes."""
    rng = np.random.default_rng(11)
    n, K = 512, 8
    W = n // 4
    words = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    sd2 = rng.integers(0, 1 << 16, n, dtype=np.int32)
    rows = np.asarray([0, 37, 0, 511, 0, 256, 2, 0], np.int32)
    co = 2 * (n - 2)
    rmin, rarg = _run(rows, co, words, sd2)
    emin, earg = _reference(rows, co, words, sd2)
    valid = rows >= 1
    np.testing.assert_array_equal(np.asarray(rmin)[valid], emin[valid])
    np.testing.assert_array_equal(np.asarray(rarg)[valid], earg[valid])


def test_qrow_mins_repeated_rows():
    rng = np.random.default_rng(13)
    n, K = 512, 8
    W = n // 4
    words = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    sd2 = rng.integers(0, 1 << 16, n, dtype=np.int32)
    rows = np.asarray([300, 300, 300, 7, 7, 511, 511, 1], np.int32)
    co = 2 * (n - 2)
    rmin, rarg = _run(rows, co, words, sd2)
    emin, earg = _reference(rows, co, words, sd2)
    np.testing.assert_array_equal(np.asarray(rmin), emin)
    np.testing.assert_array_equal(np.asarray(rarg), earg)
