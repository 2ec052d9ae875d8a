"""chip_smoke.py: its phases at tiny sizes on the CPU, its four-device
comparison on virtual CPU devices, and its refusal to pass without a GPU.
The ``gpu``-marked test runs the phases on a card (see README)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def test_smoke_reproject_phases_cpu():
    assert cs.phase_reproject_mild(0, "cpu", n=20480, scale=80, window=64) == "srw"
    assert cs.phase_reproject_rotated(0, "cpu", scale=16, window=48) == [
        "esw", "esw"
    ]
    assert cs.phase_reproject_global(0, "cpu", scale=16, window=48) == [
        "esw-mosaic"
    ]
    assert cs.phase_reproject_global(
        0, "cpu", scale=16, window=48, mosaic=False
    ) == ["gather"]
    assert "XRTPU_NO_EXACT_MOSAIC" not in os.environ


def test_smoke_affine_coarsen_phases_cpu():
    cs.phase_affine(0, "cpu", n=64, bands=2)
    cs.phase_coarsen(0, "cpu", n=64, bands=2)


def test_smoke_rectify_phase_cpu(monkeypatch):
    # the auto tier keeps the CPU on the host path; force the device tiers
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    cs.phase_rectify(0, "cpu", width=96, height=160, bands=2)
    assert os.environ["XRTPU_PHASEA"] == "device"


def test_smoke_multi_cpu_mesh():
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    cs.run_multi(0, devices, n=20480, esw_n=20480, scale=80, swath=(64, 96),
                 bands=2)


def test_smoke_fails_on_wrong_device():
    with pytest.raises(cs.SmokeFailure, match="lives on"):
        cs.device_array(jax.numpy.zeros(3), "gpu")
    with pytest.raises(cs.SmokeFailure, match="host ndarray"):
        cs.device_array(jax.numpy.zeros(3).__array__(), "cpu")


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_smoke_script_fails_without_gpu(tmp_path, alone):
    """No GPU (or no package beside the script): non-zero exit and no
    result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    res = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.fixture
def gpu():
    """Skips unless JAX's default backend is a GPU (run these tests on a
    card with ``JAX_PLATFORMS=cuda``, see README)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX's default backend is "
                    f"{jax.default_backend()!r}")


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    cs.phase_reproject_mild(0, "gpu", n=4096, window=512)
    cs.phase_reproject_rotated(0, "gpu", scale=4, window=256)
    cs.phase_affine(0, "gpu", n=256, bands=4)
    cs.phase_coarsen(0, "gpu", n=512, bands=2)
    cs.phase_rectify(0, "gpu", width=512, height=768, bands=4)
