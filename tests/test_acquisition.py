"""Acquisition tests on synthetic signals with known truth."""

import numpy as np
import pytest

from navlab_dpe_sdr_tpu.constants import F_CA, L_CA
from navlab_dpe_sdr_tpu.io.handoff import read_handoff
from navlab_dpe_sdr_tpu.io.synth import CaptureSimulator, synth_simple
from navlab_dpe_sdr_tpu.ops import acquisition as acq

FS = 2.5e6


def test_acquire_single_prn_truth():
    n = 25000  # 10 ms
    rc_true, fi_true, ri_true = 512.25, 1750.0, 0.42
    sig = synth_simple(7, FS, n, rc=rc_true, ri=ri_true, fi=fi_true,
                       cn0_dbhz=45.0, seed=3)
    res = acq.acquire(sig, [7], FS, fcaid=F_CA / 1.57542e9)[0]
    assert res.found
    # code phase to within one sample (fs/F_CA ~ 2.44 chips/sample -> 0.41)
    d = abs((res.rc - rc_true + L_CA / 2) % L_CA - L_CA / 2)
    assert d < 0.6, f"rc {res.rc} vs {rc_true}"
    # fine frequency to within an FFT bin (fs/2^18 ~ 9.5 Hz)
    assert abs(res.fi - fi_true) < 12.0, f"fi {res.fi} vs {fi_true}"


def test_acquire_absent_prn_not_found():
    n = 25000
    sig = synth_simple(7, FS, n, rc=100.0, fi=500.0, cn0_dbhz=45.0, seed=4)
    res = acq.acquire(sig, [21], FS, fcaid=F_CA / 1.57542e9)[0]
    assert not res.found
    assert res.cppm < 2.0


def test_acquire_noncoherent_mode():
    n = 25000
    sig = synth_simple(5, FS, n, rc=321.0, fi=-2200.0, cn0_dbhz=47.0, seed=5)
    res = acq.acquire(sig, [5], FS, fcaid=F_CA / 1.57542e9, coherent=False)[0]
    assert res.found
    assert abs(res.fi + 2200.0) < 260.0  # 500 Hz bins coarse + fine refine


def test_acquire_full_capture(rinex_path, handoff_path):
    """Acquire all 8 PRNs of the simulated reference scenario."""
    hand = read_handoff(handoff_path)
    arr = hand.eph_array()
    sim = CaptureSimulator(arr, hand.x_ecef, tow0=hand.rx_time_a, fs=FS,
                           cn0_dbhz=46.0)
    sig, truth = sim.generate(50000, return_truth=True)
    fcaid = F_CA / 1.57542e9
    # reference strategy: acquire on two consecutive 10 ms blocks and keep
    # the better cppm per PRN (receiver.py:452-520) — a navigation-bit flip
    # inside one block splits its carrier FFT peak
    res_a = acq.acquire(sig[:25000], hand.prn_list, FS, fcaid=fcaid)
    res_b = acq.acquire(sig[25000:], hand.prn_list, FS, fcaid=fcaid)
    for ra, rb, ch in zip(res_a, res_b, truth.channels):
        res = ra if ra.cppm >= rb.cppm else rb
        assert res.found, f"PRN {res.prn} not found (cppm={res.cppm:.2f})"
        if res is rb:
            # propagate block-2 estimates back to the capture start
            rc_back = (res.rc - res.fc * 0.01) % L_CA
        else:
            rc_back = res.rc
        d = abs((rc_back - ch.code_phase0 + L_CA / 2) % L_CA - L_CA / 2)
        assert d < 0.7, f"PRN {res.prn}: rc {rc_back:.2f} vs {ch.code_phase0:.2f}"
        assert abs(res.fi - ch.doppler0) < 40.0, \
            f"PRN {res.prn}: fi {res.fi:.1f} vs {ch.doppler0:.1f}"


def test_acquire_real_engine_matches_fft():
    """All-real acquisition must agree with the FFT engine."""
    from navlab_dpe_sdr_tpu.ops.acquisition_real import acquire_real
    n = 25000
    rc_true, fi_true = 512.25, 1750.0
    sig = synth_simple(7, FS, n, rc=rc_true, ri=0.42, fi=fi_true,
                       cn0_dbhz=45.0, seed=3)
    fcaid = F_CA / 1.57542e9
    r_fft = acq.acquire(sig, [7], FS, fcaid=fcaid)[0]
    r_real = acquire_real(sig, [7], FS, fcaid=fcaid)[0]
    assert r_real.found
    d = abs((r_real.rc - r_fft.rc + L_CA / 2) % L_CA - L_CA / 2)
    assert d < 0.5, (r_real.rc, r_fft.rc)
    assert abs(r_real.fi - r_fft.fi) < 10.0, (r_real.fi, r_fft.fi)
    assert abs(r_real.cppm - r_fft.cppm) / r_fft.cppm < 0.2


def test_acquire_real_absent_prn():
    from navlab_dpe_sdr_tpu.ops.acquisition_real import acquire_real
    sig = synth_simple(7, FS, 25000, rc=100.0, fi=500.0, cn0_dbhz=45.0,
                       seed=4)
    r = acquire_real(sig, [21], FS, fcaid=F_CA / 1.57542e9)[0]
    assert not r.found


def test_deep_acquisition_weak_signal():
    """Deep (segmented coherent x noncoherent) acquisition: at 27 dB-Hz a
    single 10 ms search misses, 200 ms of noncoherent accumulation over
    10 ms coherent folds recovers code phase and Doppler. Capability
    beyond the reference's best-of-two 10 ms search (correlator.py:53-103)."""
    from navlab_dpe_sdr_tpu.ops.acquisition_real import acquire_real
    rc_true, fi_true = 512.25, 1750.0
    cn0 = 27.0
    fcaid = F_CA / 1.57542e9
    sig = synth_simple(7, FS, 25000 * 20, rc=rc_true, ri=0.42, fi=fi_true,
                       cn0_dbhz=cn0, seed=9)
    dopplers = np.arange(-50, 51) * 50.0      # +/-2.5 kHz at T_coh=10 ms

    shallow = acquire_real(sig[:25000], [7], FS, fcaid=fcaid)[0]
    d_shallow = abs((shallow.rc - rc_true + L_CA / 2) % L_CA - L_CA / 2)
    assert not shallow.found or d_shallow > 0.6, \
        "10 ms search unexpectedly succeeded at 27 dB-Hz; lower cn0"

    deep = acquire_real(sig, [7], FS, fcaid=fcaid, dopplers=dopplers,
                        n_coh_ms=10)[0]
    assert deep.found, f"cppm={deep.cppm:.2f}"
    d = abs((deep.rc - rc_true + L_CA / 2) % L_CA - L_CA / 2)
    assert d < 0.6, f"rc {deep.rc} vs {rc_true}"
    assert abs(deep.fi - fi_true) < 30.0, deep.fi

    # absent PRN must stay below threshold in deep mode too
    miss = acquire_real(sig, [21], FS, fcaid=fcaid, dopplers=dopplers,
                        n_coh_ms=10)[0]
    assert not miss.found, f"cppm={miss.cppm:.2f}"
