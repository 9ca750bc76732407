"""Byte parity of the opt-in device (JAX) compute paths vs the default
host engines, driven through the real CLI as a subprocess.

CCPHYLO_TPU_DIST=device routes the all-pairs SNP counts through the
int8 Gram kernels; CCPHYLO_TPU_ENGINE=device64 runs the join loop on
the device.  On the CPU backend with float64 both must
reproduce the host engines' bytes exactly.
"""

import subprocess
import sys

import pytest

from .conftest import REPO
from .gen_kma_data import make_dataset


@pytest.fixture(scope="module")
def kma_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kma_dev")
    make_dataset(d, n_samples=6, length=400)
    return d


def _run(args, cwd, extra_env=None):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    env.update(extra_env or {})
    res = subprocess.run(
        [sys.executable, "-m", "ccphylo_tpu"] + args, capture_output=True,
        cwd=cwd, timeout=600, env=env)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    return res.stdout


@pytest.mark.parametrize("flags", [["-f", "17"], ["-f", "19"],
                                   ["-f", "19", "-s", "1e2"]])
def test_dist_device_kernel_parity(kma_dir, tmp_path, flags):
    import glob
    import os
    fsas = sorted(os.path.basename(p)
                  for p in glob.glob(str(kma_dir / "*.fsa.gz")))
    args = ["dist", "-r", "tmpl_1"] + flags + ["-i"] + fsas
    host = _run(args, kma_dir)
    dev = _run(args, kma_dir, {"CCPHYLO_TPU_DIST": "device"})
    assert dev == host


def test_tree_device64_parity(tmp_path):
    """Integer distances (the SNP pipeline's output) make every f64 sum
    exact, so the device engine's bytes must match the host engine's
    through the CLI.  (Float matrices can flip the final 3-way root tie
    on summation-order ulps — covered topologically in
    test_jax_engine.py.)"""
    import io

    import numpy as np

    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    n = 120
    rng = np.random.RandomState(42)
    flat = rng.randint(0, 500, n * (n - 1) // 2).astype(np.float64)
    names = [Name(b"t%03d" % i, 32) for i in range(n)]
    buf = io.BytesIO()
    print_phy(buf, n, flat, names)
    phy = tmp_path / "int.phy"
    phy.write_bytes(buf.getvalue())

    args = ["tree", "-m", "dnj", "-i", str(phy)]
    host = _run(args, tmp_path)
    dev = _run(args, tmp_path, {"CCPHYLO_TPU_ENGINE": "device64"})
    assert dev == host


def test_tree_sharded64_parity(tmp_path):
    """CCPHYLO_TPU_ENGINE=sharded64 -m dnj on a 4-device mesh: integer
    distances make the float64 trajectory exact, so the bytes equal the
    host engine's."""
    import io

    import numpy as np

    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    n = 200
    rng = np.random.RandomState(200)
    flat = rng.randint(0, 500, n * (n - 1) // 2).astype(np.float64)
    buf = io.BytesIO()
    print_phy(buf, n, flat, [Name(b"t%03d" % i, 32) for i in range(n)])
    phy = tmp_path / "int.phy"
    phy.write_bytes(buf.getvalue())

    args = ["tree", "-m", "dnj", "-i", str(phy)]
    host = _run(args, tmp_path)
    dev = _run(args, tmp_path, {
        "CCPHYLO_TPU_ENGINE": "sharded64",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert dev == host


def test_tree_device64_quantized_parity(tmp_path):
    """-s (u16 ByteScale) through the CLI: quantized device storage +
    f64 compute matches the host exact engine's bytes."""
    import io

    import numpy as np

    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    n = 90
    rng = np.random.RandomState(7)
    flat = rng.uniform(0.01, 60.0, n * (n - 1) // 2)
    names = [Name(b"t%03d" % i, 32) for i in range(n)]
    buf = io.BytesIO()
    print_phy(buf, n, flat, names)
    phy = tmp_path / "q.phy"
    phy.write_bytes(buf.getvalue())

    args = ["tree", "-m", "dnj", "-s", "1e3", "-i", str(phy)]
    host = _run(args, tmp_path)
    dev = _run(args, tmp_path, {"CCPHYLO_TPU_ENGINE": "device64"})
    assert dev == host


def test_tree_packed64_quantized_parity(tmp_path):
    """-b (u8 ByteScale) through the CLI with CCPHYLO_TPU_ENGINE=packed64:
    u32-packed blocked device storage + f64 compute matches the host
    exact engine's bytes (the packed engine, reachable from the CLI,
    with oracle-level parity).

    ByteScale 64 (a power of two) makes every dequantized cell k/64
    exactly representable, so all f64 sums are exact and parity is
    deterministic; non-dyadic scales (1e2) leave Q ties to
    fusion-order ulps — the engines' documented f-dtype caveat."""
    import io

    import numpy as np

    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    n = 150
    rng = np.random.RandomState(77)
    flat = rng.uniform(0.01, 2.0, n * (n - 1) // 2)
    names = [Name(b"t%03d" % i, 32) for i in range(n)]
    buf = io.BytesIO()
    print_phy(buf, n, flat, names)
    phy = tmp_path / "p.phy"
    phy.write_bytes(buf.getvalue())

    args = ["tree", "-m", "dnj", "-b", "64", "-i", str(phy)]
    host = _run(args, tmp_path)
    dev = _run(args, tmp_path, {"CCPHYLO_TPU_ENGINE": "packed64"})
    assert dev == host
    # odd block counts exercise the lcm padding
    dev3 = _run(args, tmp_path, {"CCPHYLO_TPU_ENGINE": "packed64",
                                 "CCPHYLO_TPU_NB": "3"})
    assert dev3 == host


def test_dist_mat_device_kernel(kma_dir, tmp_path):
    """The .mat device path (cos VPU kernel) matches the host engine:
    integer outputs (.num and integer D cells) byte-identical; float
    cells within the documented f32-sum tolerance."""
    import glob
    import os
    mats = sorted(os.path.basename(p)
                  for p in glob.glob(str(kma_dir / "*.mat.gz")))
    args = ["dist", "-r", "tpl1", "-f", "1", "-i"] + mats
    host = _run(args, kma_dir)
    dev = _run(args, kma_dir, {"CCPHYLO_TPU_DIST": "device"})

    def parse(out):
        rows = []
        for line in out.split(b"\n")[1:]:
            if line:
                rows.extend(float(x) for x in line.split(b"\t")[1:])
        return rows

    h, d = parse(host), parse(dev)
    assert len(h) == len(d) and len(h) > 0
    for a, b in zip(h, d):
        assert a == b or abs(a - b) <= 2e-5 * max(abs(a), 1.0), (a, b)


def test_dist_mat_device_num_matrix_exact(kma_dir, tmp_path):
    import glob
    import os
    mats = sorted(os.path.basename(p)
                  for p in glob.glob(str(kma_dir / "*.mat.gz")))
    nh, nd = tmp_path / "h.num", tmp_path / "d.num"
    args = ["dist", "-r", "tpl1", "-f", "1", "-i"] + mats
    _run(args + ["-n", str(nh), "-o", os.devnull], kma_dir)
    _run(args + ["-n", str(nd), "-o", os.devnull], kma_dir,
         {"CCPHYLO_TPU_DIST": "device"})
    assert nh.read_bytes() == nd.read_bytes()


def test_tree_device64_oracle_1k_tied(oracle, tmp_path):
    """Oracle-level tie-exactness at n=1000: small-range integer
    distances put a Q tie in nearly every join; the device batch scan's
    bytes must equal the C reference's."""
    import io

    import numpy as np

    from .conftest import run_oracle
    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    n = 1000
    rng = np.random.RandomState(1000)
    flat = rng.randint(0, 50, n * (n - 1) // 2).astype(np.float64)
    names = [Name(b"t%04d" % i, 32) for i in range(n)]
    buf = io.BytesIO()
    print_phy(buf, n, flat, names)
    phy = tmp_path / "tied1k.phy"
    phy.write_bytes(buf.getvalue())

    args = ["tree", "-m", "dnj", "-i", str(phy)]
    ref = run_oracle(oracle, args)
    dev = _run(args, tmp_path, {"CCPHYLO_TPU_ENGINE": "device64"})
    assert dev == ref


@pytest.fixture(scope="module")
def float_phy(tmp_path_factory):
    """A seeded 183-taxon float matrix (non-integer cells): distances
    between random points plus noise, written as Phylip."""
    import io

    import numpy as np

    from ccphylo_tpu.io.phylip import print_phy
    from ccphylo_tpu.io.qseqs import Name

    n = 183
    rng = np.random.RandomState(183)
    pts = rng.uniform(0.0, 1.0, (n, 8))
    D = np.abs(pts[:, None, :] - pts[None, :, :]).sum(axis=2)
    iu = np.tril_indices(n, -1)
    flat = D[iu] + rng.uniform(0.0, 0.05, len(iu[0]))
    names = [Name(b"s%03d" % i, 32) for i in range(n)]
    buf = io.BytesIO()
    print_phy(buf, n, flat, names)
    phy = tmp_path_factory.mktemp("float_phy") / "float.phy"
    phy.write_bytes(buf.getvalue())
    return phy


@pytest.mark.parametrize("method", ["upgma", "cf", "mn", "ff", "hnj",
                                    "nj"])
def test_tree_device_float_guard(method, float_phy):
    """Float (non-integer) matrices through CCPHYLO_TPU_ENGINE=device:
    every hclust-family method must match the host byte-parity engine —
    upgma/cf/mn run on device (parity on floats by design), ff/hnj/nj
    fall back to the host engine with a stderr note (the device engine
    is only tie-exact on integer data for those three)."""
    args = ["tree", "-m", method, "-i", str(float_phy)]
    host = _run(args, REPO)
    # upgma/cf/mn: device64 is the documented float-parity tier (f32
    # limb printing differs in last digits); ff/hnj/nj: any device
    # tier must fall back on float data
    eng = "device64" if method in ("upgma", "cf", "mn") else "device"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "CCPHYLO_TPU_ENGINE": eng}
    res = subprocess.run(
        [sys.executable, "-m", "ccphylo_tpu"] + args,
        capture_output=True, cwd=REPO, timeout=600, env=env)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    assert res.stdout == host
    if method in ("ff", "hnj", "nj"):
        assert b"using the host engine" in res.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [["-f", "17"], ["-f", "19"]])
def test_dist_device_kernel_parity_gpu(kma_dir, gpu_env, flags):
    """The device SNP fill compiled for the GPU gives the host bytes."""
    import glob
    import os
    fsas = sorted(os.path.basename(p)
                  for p in glob.glob(str(kma_dir / "*.fsa.gz")))
    args = ["dist", "-r", "tmpl_1"] + flags + ["-i"] + fsas
    host = _run(args, kma_dir)
    dev = _run(args, kma_dir, dict(gpu_env, CCPHYLO_TPU_DIST="device"))
    assert dev == host
