"""Test harness config: force CPU JAX with a virtual 8-device mesh so that
multi-device sharding tests run anywhere. The GPU path is exercised on the
card by chip_smoke.py; a test that needs the card carries the `gpu` marker
and decides inside a fixture, never at import."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pathlib
import tempfile

import numpy as np
import pytest

from navlab_dpe_sdr_tpu.device import use_compile_cache  # noqa: E402

# Large FFT compiles are slow; cache compiled executables across test runs
# (JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache).
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

REPO = pathlib.Path(__file__).resolve().parent.parent
REFDATA = pathlib.Path("/root/reference/demofiles")


@pytest.fixture(scope="session")
def rinex_path():
    p = REFDATA / "nist1860.18n"
    if not p.exists():
        pytest.skip("reference RINEX fixture not available")
    return str(p)


@pytest.fixture(scope="session")
def handoff_path():
    p = REFDATA / "handoff_params_usrp6.csv"
    if not p.exists():
        pytest.skip("reference handoff fixture not available")
    return str(p)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


# v3: CaptureSimulator output changed in round 2 (complex64 signal, f32
# noise stream) — bump so stale caches from the old generator are not mixed
# with bounds calibrated against the new one.
CAPTURE_VERSION = "v3"
CAPTURE_SECONDS = 40.0


@pytest.fixture(scope="session")
def capture_40s(handoff_path):
    """(path, meta, handoff) of a cached 40 s simulated capture at the
    handoff state. Session-scoped and disk-cached: generated once, shared
    by the scalar e2e and DPE golden tests regardless of test order.
    Generation is flock-guarded and atomically renamed so concurrent xdist
    workers (pytest defaults to -n 4) neither duplicate the work nor read
    a half-written capture."""
    import fcntl
    import json

    from navlab_dpe_sdr_tpu.io.handoff import read_handoff
    from navlab_dpe_sdr_tpu.io.synth import CaptureSimulator

    fs = 2.5e6
    cache = pathlib.Path(tempfile.gettempdir()) / "navlab_fixtures"
    cache.mkdir(exist_ok=True)
    dat = cache / f"capture40_{CAPTURE_VERSION}.dat"
    meta_p = cache / f"capture40_{CAPTURE_VERSION}.json"
    hand = read_handoff(handoff_path)
    if not (dat.exists() and meta_p.exists()):
        with open(cache / f"capture40_{CAPTURE_VERSION}.lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if not (dat.exists() and meta_p.exists()):   # re-check in lock
                arr = hand.eph_array()
                tow0 = hand.rx_time_a - 6.0
                sim = CaptureSimulator(arr, hand.x_ecef, tow0=tow0, fs=fs,
                                       cn0_dbhz=47.0, nav_data=True, seed=99)
                tmp = dat.with_suffix(".dat.tmp")
                sim.write_capture(str(tmp), CAPTURE_SECONDS)
                tmp.rename(dat)
                meta = {"tow0": tow0,
                        "rx_ecef": list(map(float, hand.x_ecef)),
                        "prns": hand.prn_list, "fs": fs}
                meta_p.write_text(json.dumps(meta))
    return str(dat), json.loads(meta_p.read_text()), hand
