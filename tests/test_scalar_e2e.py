"""End-to-end scalar pipeline: synthetic capture -> acquisition -> tracking
-> LNAV decode -> PVT -> handoff, validated against simulation ground truth.

The 40 s capture is generated once and cached in /tmp (keyed by a version
string) because synthesis is the expensive part.
"""

import json
import os
import pathlib

import numpy as np
import pytest

from navlab_dpe_sdr_tpu.constants import C, L_CA
from navlab_dpe_sdr_tpu.io.handoff import read_handoff
from navlab_dpe_sdr_tpu.io.rawfile import SampleFile
from navlab_dpe_sdr_tpu.io.synth import CaptureSimulator
from navlab_dpe_sdr_tpu.models.scalar import ScalarReceiver

# the shared 40 s capture fixture lives in conftest.py (session-scoped,
# disk-cached) so test order doesn't matter

FS = 2.5e6


@pytest.mark.slow
def test_scalar_pipeline_end_to_end(capture_40s, tmp_path):
    dat, meta, hand = capture_40s
    rf = SampleFile(dat, fs=meta["fs"])
    rx = ScalarReceiver(rf, meta["prns"])

    res = rx.acquire(verbose=False)
    assert all(r.found for r in res), [r.cppm for r in res]

    rx.track(36000)  # 36 s

    good = rx.decode_ephemerides(verbose=False)
    assert set(good) == set(meta["prns"]), f"decoded only {good}"
    for prn in good:
        eph = rx.channels[prn].ephemeris
        assert eph.complete
        # decoded fields must match what the simulator transmitted
        src = [e for e in hand.eph_array().ephs if e.prn == prn][0]
        assert abs(eph.sqrt_A - src.sqrt_A) < 1e-3
        assert abs(eph.t_oe - src.t_oe) < 1e-9
        assert abs(eph.M_0 - src.M_0) < 1e-8

    # PVT at the last measurement epoch vs simulation truth
    rx_time_a, rx_time, x_ecef, x_eci, sats_eci = rx.nav_solution()
    truth = np.array(meta["rx_ecef"])
    err = np.linalg.norm(x_ecef[0:3] - truth[0:3])
    assert err < 15.0, f"position error {err:.1f} m"
    # velocity near zero (static receiver, zero modeled drift)
    assert np.linalg.norm(x_ecef[4:7]) < 0.5

    # true receive time at the last measurement epoch (observables at mc
    # describe the start of window mc)
    t_expect = meta["tow0"] + (rx.mcount - 1) * 1e-3
    assert abs(rx_time_a - t_expect) < 2e-6 * 40 + 1e-5

    # handoff export/import round trip
    out = str(tmp_path / "test_handoff.csv")
    h = rx.save_handoff(out)
    h2 = read_handoff(out)
    np.testing.assert_allclose(h2.x_ecef, h.x_ecef, rtol=0, atol=1e-9)
    np.testing.assert_allclose(h2.rc, h.rc, atol=1e-9)
    assert h2.bytes_read == h.bytes_read
    arr2 = h2.eph_array()
    assert arr2.ephs[0].sqrt_A > 5000


@pytest.mark.slow
def test_scalar_coherent_tracking_pvt(capture_40s):
    """Full-geometry capture tracked at coh_ms=4 (coherent predetection
    integration): acquisition-grade init must pull in under FLL assist,
    the cp bookkeeping must stay exact across the 4 ms windows, and the
    PVT from the coherent-mode observables must match truth."""
    from navlab_dpe_sdr_tpu.ops.tracking import LoopConfig

    dat, meta, hand = capture_40s
    rf = SampleFile(dat, fs=meta["fs"])
    rx = ScalarReceiver(rf, meta["prns"],
                        loops=LoopConfig(order=2, bn_code=2.0,
                                         bn_carr=12.0, bn_carr_freq=3.0))
    res = rx.acquire(verbose=False)
    assert all(r.found for r in res), [r.cppm for r in res]

    rx.track(36000, coh_ms=4)  # 36 s, 9000 loop updates

    # LNAV decode straight through the coherent mode: the per-code-period
    # cp_sign stream is cadence-independent, so frame sync and ephemeris
    # decode must work identically on 4 ms windows
    good = rx.decode_ephemerides(verbose=False)
    assert set(good) == set(meta["prns"]), f"decoded only {good}"

    rx_time_a, rx_time, x_ecef, x_eci, sats = rx.nav_solution()
    truth = np.array(meta["rx_ecef"])
    err = np.linalg.norm(x_ecef[0:3] - truth[0:3])
    assert err < 15.0, f"position error {err:.1f} m"
    assert np.linalg.norm(x_ecef[4:7]) < 0.5

    # observables are at the start of the last 4 ms window
    t_expect = meta["tow0"] + (rx.mcount - 1) * rx.coh_ms * 1e-3
    assert abs(rx_time_a - t_expect) < 2e-6 * 40 + 1e-5
