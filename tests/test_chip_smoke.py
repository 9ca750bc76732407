"""chip_smoke.py must fail, and never claim success, where it cannot
run on a GPU: without nvidia-smi, without a device JAX can use, and
outside a checkout of the repository."""

import shutil
import subprocess
import sys

import pytest

from .conftest import REPO


@pytest.mark.parametrize("where", ["no_smi", "no_device", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = REPO / "chip_smoke.py"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    if where == "no_device":
        smi = bindir / "nvidia-smi"
        smi.write_text("#!/bin/sh\necho 'stub GPU, 700.00 W'\n")
        smi.chmod(0o755)
    # CUDA_VISIBLE_DEVICES hides any real card from JAX
    env = {"PATH": str(bindir), "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(script)], env=env,
                         cwd=tmp_path, capture_output=True, timeout=300)
    assert res.returncode != 0
    assert b'"ok": true' not in res.stdout
    assert not (REPO / "chip_smoke_data").exists() or where == "alone"
