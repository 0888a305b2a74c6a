"""chip_smoke.py off the card: it refuses to run without a GPU, its last
line has the exact contract keys, and its phases run end to end at tiny
sizes on the CPU (the mesh phase on four virtual CPU devices)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def tiny_scene():
    from navlab_dpe_sdr_tpu.models.grid import uniform_grid
    samples, truth, arr = chip_smoke.synth_capture(0.3)
    return samples, truth, arr, uniform_grid(n=5)


def _run(cmd, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (or none of the repo beside it): nonzero exit, no result."""
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    else:
        cwd = REPO
    r = _run([sys.executable, "chip_smoke.py"], cwd)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_fails_without_gpu():
    r = _run([sys.executable, "bench.py", "10"], REPO)
    assert r.returncode != 0
    assert "dpe_real_time_factor" not in r.stdout


def test_result_line_exact_keys():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True,
                                "device": {"platform": "gpu",
                                           "kind": "NVIDIA H100 80GB HBM3",
                                           "count": 1}}


def test_check_raises_on_failure(capsys):
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.check(False, "broken")
    assert "FAIL broken" in capsys.readouterr().out


def test_synth_capture_is_seeded(tiny_scene):
    samples = tiny_scene[0]
    again, _, _ = chip_smoke.synth_capture(0.3)
    assert samples.shape == (int(0.3 * chip_smoke.FS),)
    np.testing.assert_array_equal(samples, again)


def test_parity_phase_tiny(tiny_scene):
    from navlab_dpe_sdr_tpu.constants import F_CA, F_L1
    from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table
    from navlab_dpe_sdr_tpu.ops import tracking as trk

    samples, truth, arr, grid = tiny_scene
    st = trk.init_state(rc=truth.rc, ri=truth.ri, fc=truth.fc, fi=truth.fi)
    raw = samples[:40 * 2500].view(np.int16).reshape(40, 2500, 2)
    rep = chip_smoke.parity(samples, truth, arr, grid, st, raw,
                            ca_table(truth.prn_list).astype(np.float32),
                            F_CA / F_L1)
    assert rep["track_steps"] == 40
    assert rep["pos_score_points_compared"] > 0


def test_dpe_phase_tiny(tiny_scene):
    samples, truth, arr, grid = tiny_scene
    chip_smoke.dpe(samples, truth, arr, truth, grid, n_blocks=4,
                   n_grouped=10, group_k=5)


def test_four_phase_on_four_cpu_devices(tiny_scene):
    """The --four comparison: dpe_batch_blocks over a grid=4 mesh of
    virtual CPU devices vs one device, per-block and grouped K=4."""
    samples, truth, arr, grid = tiny_scene
    assert len(jax.devices()) >= 4, "conftest provides 8 CPU devices"
    rep = chip_smoke.four(samples, truth, arr, grid, jax.devices()[:4],
                          n_blocks=8)
    assert rep["mesh"] == {"chan": 1, "grid": 4}
    assert rep["k1_rows"] == 8 and rep["k4_rows"] == 2
