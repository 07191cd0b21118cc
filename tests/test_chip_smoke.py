"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU (and
alone, without the package), and each phase runs through at tiny sizes
(the kernel in the Pallas interpreter)."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(cwd, pythonpath):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=180)


def test_refuses_without_gpu():
    r = _run(ROOT, str(ROOT))
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_refuses_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path, None)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.phase_device()


def test_phase_saga_tiny():
    chip_smoke.phase_saga(shape=(4096, 64), batch=256, max_epochs=4096)


def test_phase_kernel_tiny():
    chip_smoke.phase_kernel(shapes=((1024, 64), (2048, 100)), batch=256,
                            reps=2, interpret=True)


def test_phase_families_tiny():
    chip_smoke.phase_families(shape=(4096, 64), batch=256,
                              sharing_shape=(1024, 32))


def test_phase_deep_tiny():
    chip_smoke.phase_deep(shape=(65536, 32), batch=1024, example=False)


def test_phase_multi_tiny():
    """The four-card phase on four of the suite's virtual CPU devices."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_multi(shape=(8192, 32), batch=256, cards=4)
