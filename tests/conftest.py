import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

# JAX tests run on a virtual 8-device CPU mesh (multi-device shardings
# are validated without accelerator hardware).  Tests that need the GPU
# carry the `gpu` marker and drive the program in a subprocess.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           ).strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
ORACLE_DIR = Path("/tmp/ccphylo_oracle")

sys.path.insert(0, str(REPO))


def _build_oracle() -> Path | None:
    """Build the reference C binary once as the golden-output oracle."""
    binary = ORACLE_DIR / "ccphylo"
    if binary.exists():
        return binary
    if not REFERENCE.exists():
        return None
    ORACLE_DIR.mkdir(parents=True, exist_ok=True)
    for f in REFERENCE.glob("*.c"):
        shutil.copy(f, ORACLE_DIR)
    for f in REFERENCE.glob("*.h"):
        shutil.copy(f, ORACLE_DIR)
    shutil.copy(REFERENCE / "Makefile", ORACLE_DIR)
    try:
        subprocess.run(["make", "-j8"], cwd=ORACLE_DIR, check=True,
                       capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    return binary if binary.exists() else None


@pytest.fixture(scope="session")
def oracle():
    binary = _build_oracle()
    if binary is None:
        pytest.skip("reference oracle unavailable")
    return binary


@pytest.fixture(scope="session")
def test_phy() -> Path:
    p = REFERENCE / "test.phy.gz"
    if not p.exists():
        pytest.skip("test.phy.gz unavailable")
    return p


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU visible to JAX; skips "
        "without one (run on the card with `pytest tests -m gpu`)")


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a subprocess that must run on the GPU; skips the
    test when no GPU is visible to JAX."""
    env = {"PYTHONPATH": str(REPO), "PATH": os.environ.get("PATH", ""),
           "JAX_PLATFORMS": "cuda"}
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; jax.devices('gpu')"],
        env=env, capture_output=True, timeout=300)
    if probe.returncode != 0:
        pytest.skip("JAX finds no GPU")
    return env


def run_oracle(binary, args, stdin: bytes = b"") -> bytes:
    res = subprocess.run([str(binary)] + args, input=stdin,
                         capture_output=True, timeout=600)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    return res.stdout


def run_ours(args, stdin: bytes = b"") -> bytes:
    res = subprocess.run([sys.executable, "-m", "ccphylo_tpu"] + args,
                         input=stdin, capture_output=True, cwd=REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    return res.stdout
