"""Scalar tracking loop tests on constant-rate synthetic signals."""

import numpy as np
import jax.numpy as jnp
import pytest

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu.io.synth import synth_simple
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu.ops import tracking

FS = 2.5e6
S = 2500
FCAID = F_CA / F_L1


def _make_blocks(prn, n_ms, rc, ri, fi, cn0=48.0, bits=None, seed=0):
    fc = F_CA + FCAID * fi
    sig = synth_simple(prn, FS, n_ms * S, rc=rc, ri=ri, fc=fc, fi=fi,
                       cn0_dbhz=cn0, bits=bits, seed=seed)
    return sig.reshape(n_ms, S).astype(np.complex64)


def test_tracking_converges_from_offset():
    """Start 0.3 chips / 25 Hz off; loops must pull in and stay locked."""
    prn, rc0, ri0, fi0 = 7, 500.0, 0.1, 1234.0
    raw = _make_blocks(prn, 1000, rc0, ri0, fi0)
    code_tab = jnp.asarray(ca_table([prn]).astype(np.float32))

    st = tracking.init_state(rc=[rc0 + 0.3], ri=[ri0], fc=[F_CA + FCAID * (fi0 + 25)],
                             fi=[fi0 + 25.0])
    st, log = tracking.track_chunk(st, jnp.asarray(raw), code_tab, FS, FCAID)

    fi_track = np.asarray(log.fi)[:, 0]
    rc_track = np.asarray(log.rc)[:, 0]
    # converged Doppler within 2 Hz over the last 200 ms
    assert abs(np.mean(fi_track[-200:]) - fi0) < 2.0, np.mean(fi_track[-200:])
    # code phase error: true rc at step k is (rc0 + fc0*T*k) mod L_CA
    k = np.arange(1000)
    fc0 = F_CA + FCAID * fi0
    rc_true = np.mod(rc0 + (fc0 - F_CA) * 1e-3 * k, L_CA)
    err = np.abs(((rc_track - rc_true) + L_CA / 2) % L_CA - L_CA / 2)
    assert np.mean(err[-200:]) < 0.05, np.mean(err[-200:])
    # lock achieved by the end
    assert int(np.asarray(log.lock)[-1, 0]) == 1
    # SNR estimate in a plausible C/N0 band
    assert 38.0 < float(np.asarray(log.snr)[-1, 0]) < 55.0


def test_tracking_recovers_nav_bits():
    """Completed-code-period signs must reproduce the transmitted bit stream."""
    prn, rc0, fi0 = 3, 100.0, -800.0
    rng = np.random.default_rng(11)
    bits = np.where(rng.standard_normal(80) > 0, 1.0, -1.0)
    raw = _make_blocks(prn, 1000, rc0, 0.0, fi0, cn0=50.0, bits=bits, seed=2)
    code_tab = jnp.asarray(ca_table([prn]).astype(np.float32))

    st = tracking.init_state(rc=[rc0], ri=[0.0], fc=[F_CA + FCAID * fi0], fi=[fi0])
    st, log = tracking.track_chunk(st, jnp.asarray(raw), code_tab, FS, FCAID)

    ncp = np.asarray(log.ncp)[:, 0]
    signs = np.asarray(log.signs)[:, 0, :]
    cp_sign = []
    for t in range(1000):
        for j in range(ncp[t]):
            cp_sign.append(signs[t, j])
    cp_sign = np.array(cp_sign)

    # skip the pull-in transient, compare the folded bits
    # signal bit for code period c is bits[(c + bit_phase) // 20]
    # (synth_simple bit_phase_cp=0); cp_sign is -sign(prompt) with the sign
    # convention of the reference (data bit 1 <-> prompt negative)
    n_cp = len(cp_sign)
    assert n_cp in (999, 1000, 1001)
    cps = np.arange(n_cp)
    true_bits = bits[np.clip(cps // 20, 0, len(bits) - 1)]
    agree = np.mean(cp_sign[200:900] == -true_bits[200:900])
    disagree = np.mean(cp_sign[200:900] == true_bits[200:900])
    assert max(agree, disagree) > 0.995, (agree, disagree)


def test_tracking_two_channels_independent():
    """Two PRNs tracked in one batch must match tracking them separately."""
    p1, p2 = 5, 9
    raw1 = _make_blocks(p1, 300, 200.0, 0.0, 1000.0, seed=3)
    raw2 = _make_blocks(p2, 300, 700.0, 0.5, -2000.0, seed=4)
    raw = raw1 + raw2  # both PRNs in the same samples
    tab = jnp.asarray(ca_table([p1, p2]).astype(np.float32))

    st = tracking.init_state(rc=[200.0, 700.0], ri=[0.0, 0.5],
                             fc=[F_CA + FCAID * 1000.0, F_CA - FCAID * 2000.0],
                             fi=[1000.0, -2000.0])
    st, log = tracking.track_chunk(st, jnp.asarray(raw), tab, FS, FCAID)
    fi_end = np.asarray(log.fi)[-50:, :].mean(axis=0)
    assert abs(fi_end[0] - 1000.0) < 3.0
    assert abs(fi_end[1] + 2000.0) < 3.0


def _py_loopfilter(xps, xfs, order, bn, bn_f, boxcar, T=1e-3):
    """Independent float64 transcription of the critically damped
    bilinear/boxcar loop difference equations (Misra & Enge p.478,
    Kaplan & Hegarty p.181; reference loopfilter.py:28-121)."""
    if order == 2:
        w0p = bn / 0.53
        kap, kvp, kpp = 0.0, w0p ** 2, 1.414 * w0p
        w0f = bn_f / 0.25
        kaf, kvf = 0.0, w0f
    else:
        w0p = bn / 0.7845
        kap, kvp, kpp = w0p ** 3, 1.1 * w0p ** 2, 2.4 * w0p
        w0f = bn_f / 0.53
        kaf, kvf = w0f ** 2, 1.414 * w0f
    h = h2 = 0.0
    outs = []
    for xp, xf in zip(xps, xfs):
        if order == 2:
            acc = 0.0
        else:
            h2_new = h2 + T * (kap * xp + kaf * xf)
            acc = h2_new if boxcar else (h2_new + h2) / 2.0
            h2 = h2_new
        h_new = h + T * (acc + kvp * xp + kvf * xf)
        vel = h_new if boxcar else (h_new + h) / 2.0
        h = h_new
        outs.append(vel + kpp * xp)
    return np.array(outs)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("boxcar", [False, True])
def test_loop_filter_difference_equation_parity(order, boxcar):
    """_lf_step must reproduce the reference difference equations."""
    rng = np.random.default_rng(42)
    xps = rng.standard_normal(50) * 0.1
    xfs = rng.standard_normal(50) * 0.05
    bn, bn_f = 18.0, 2.0
    coeffs = tracking._loop_coeffs(order, bn, bn_f)

    h = jnp.zeros(1)
    h2 = jnp.zeros(1)
    got = []
    for xp, xf in zip(xps, xfs):
        h, h2, out = tracking._lf_step(
            h, h2, jnp.float32(xp), jnp.float32(xf), coeffs, boxcar)
        got.append(float(out[0]))
    want = _py_loopfilter(xps, xfs, order, bn, bn_f, boxcar)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def _make_ramp_blocks(prn, n_ms, rc0, fi0, ramp, cn0=48.0, seed=5):
    """Chirp: fi(t) = fi0 + ramp*t, code rate coherently scaled (FCAID)."""
    from navlab_dpe_sdr_tpu.libgnss.cacode import ca_code

    n = n_ms * S
    t = np.arange(n) / FS
    ph = fi0 * t + 0.5 * ramp * t * t          # integral of fi(t)
    fidc = rc0 + F_CA * t + FCAID * ph         # code phase [chips]
    chips = ca_code(prn)[np.mod(np.floor(fidc), L_CA).astype(np.int64)]
    sig = chips * np.exp(2j * np.pi * ph)
    amp = 32.0 * np.sqrt(10.0 ** (cn0 / 10.0) / FS)
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * (32.0 / np.sqrt(2))
    return (amp * sig + noise).reshape(n_ms, S).astype(np.complex64)


def test_third_order_holds_doppler_ramp():
    """Under a strong Doppler ramp the 3rd-order PLL holds with ~zero
    steady-state frequency lag while the 2nd-order lags (VERDICT item 8:
    improved hold under clock-drift-like dynamics)."""
    prn, rc0, fi0, ramp = 4, 300.0, 500.0, 800.0   # 800 Hz/s ~ 16 g LOS
    n_ms = 800
    raw = jnp.asarray(_make_ramp_blocks(prn, n_ms, rc0, fi0, ramp))
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))

    lag = {}
    lock = {}
    for order in (2, 3):
        st = tracking.init_state(rc=[rc0], ri=[0.0],
                                 fc=[F_CA + FCAID * fi0], fi=[fi0])
        st, log = tracking.track_chunk(
            st, raw, tab, FS, FCAID, tracking.LoopConfig(order=order))
        lag[order] = float(np.asarray(log.dpi)[-300:, 0].mean())
        lock[order] = int(np.asarray(log.lock)[-1, 0])

    # 2nd order: steady-state phase lag ramp/w0^2 = 800/(40/0.53)^2 = 0.140
    # cycles -- enough to trip the Kaplan lock detector. 3rd order: ~zero
    # lag (ramp is type-2 input to a type-3 loop) and phase lock held.
    assert abs(lag[2] - 0.140) < 0.03, lag
    assert abs(lag[3]) < 0.01, lag
    assert lock[2] == 0 and lock[3] == 1, lock


def test_epl_onehot_matches_gather():
    """The merged half-chip one-hot E/P/L lookup (gather-free) must reproduce
    the direct three-gather lookup. floor(2x) determines all three taps
    exactly, so the only legitimate differences are f32 ties where x +/- 0.5
    itself rounds across a chip boundary — none at these test phases."""
    rng = np.random.default_rng(5)
    tab = jnp.asarray(ca_table([7, 12, 19]).astype(np.float32))
    base = jnp.asarray((np.arange(S) / FS * F_CA).astype(np.float32))
    # includes the wrap-sensitive region near 0 / L_CA and sub-chip offsets
    phase = jnp.asarray(np.array([0.125, 1022.7, 511.0 + rng.random()],
                                 np.float32))
    got = tracking._epl_onehot(tab, base, phase)
    want = tracking._epl_gather(tab, base, phase)
    mismatch = np.mean(np.asarray(got) != np.asarray(want))
    assert mismatch == 0.0, f"replica mismatch fraction {mismatch}"


def test_epl_onehot_factored_matches_gather():
    """The two-level factored one-hot (93x22 split of the 2046 half-chip
    bins) must be bit-exact against the direct gather — including at the
    j = 22k factor boundaries where a naive f32 j/22 division could round
    floor() the wrong way (phase 0.0 puts channel 0 exactly on j = 0; the
    dense phase sweep crosses every h boundary)."""
    rng = np.random.default_rng(11)
    tab = jnp.asarray(ca_table([3, 7, 12, 19]).astype(np.float32))
    base = jnp.asarray((np.arange(S) / FS * F_CA).astype(np.float32))
    for phase in (np.array([0.0, 0.125, 1022.7, 511.0 + rng.random()],
                           np.float32),
                  # every h-boundary: phases k*11 chips (j steps of 22)
                  np.linspace(0.0, 1023.0, 4, endpoint=False
                              ).astype(np.float32) + np.float32(10.997)):
        got = tracking._epl_onehot_factored(tab, base, jnp.asarray(phase))
        want = tracking._epl_gather(tab, base, jnp.asarray(phase))
        mismatch = np.mean(np.asarray(got) != np.asarray(want))
        assert mismatch == 0.0, f"replica mismatch fraction {mismatch}"


def test_epl_const_fold_matches_exact_gather():
    """The constant-table period-fold lookup ("constfold") must equal the
    EXACT-arithmetic half-chip gather: j = floor(2*base0 + 2*rc) evaluated
    in f64, E/P/L = r2[j+1], r2[j], r2[j-1] (the _epl_onehot identities).
    Unlike the f32-base paths there is no rounding jitter to excuse."""
    rng = np.random.default_rng(17)
    prns = [3, 9, 23, 30]
    tab_np = ca_table(prns).astype(np.float32)
    period = S
    for phases in (np.array([0.0, 0.125, 1022.7, 511.0 + rng.random()],
                            np.float32),
                   rng.uniform(0.0, 1023.0, len(prns)).astype(np.float32),
                   np.linspace(0.0, 1023.0, len(prns), endpoint=False
                               ).astype(np.float32) + np.float32(10.997)):
        got = np.asarray(tracking._epl_const_fold(
            jnp.asarray(tab_np), jnp.asarray(phases), period, 1))
        base2 = np.arange(period) * (2.0 * 1023.0 / period)    # f64 exact
        for c in range(len(prns)):
            j = np.floor(base2 + 2.0 * np.float64(phases[c])
                         ).astype(np.int64) % 2046
            r2 = np.repeat(tab_np[c], 2)
            want = np.stack([r2[(j + 1) % 2046], r2[j],
                             r2[(j - 1) % 2046]], axis=-1)
            np.testing.assert_array_equal(got[c], want)

    # exact periodicity: n_periods tiling == per-period result repeated
    got1 = np.asarray(tracking._epl_const_fold(
        jnp.asarray(tab_np), jnp.asarray(phases), period, 1))
    got4 = np.asarray(tracking._epl_const_fold(
        jnp.asarray(tab_np), jnp.asarray(phases), period, 4))
    np.testing.assert_array_equal(got4, np.tile(got1, (1, 4, 1)))


def test_tracking_converges_with_const_fold_path(monkeypatch):
    """Closed-loop tracking through the constant-table replica path
    ("constfold") converges like the gather path: same pull-in, nav-bit
    stream intact. Trajectories are compared loosely — the const path's
    exact half-chip decisions differ from the f32-base gather at ~1
    boundary sample per window, which perturbs discriminator noise, not
    dynamics."""
    monkeypatch.setattr(
        tracking, "_epl_replicas",
        lambda t, b, p, period=None, n_periods=1, **kw:
        tracking._epl_const_fold(t, p, period, n_periods))
    prn, rc0, ri0, fi0 = 5, 250.0, 0.4, 900.0
    raw = jnp.asarray(_make_blocks(prn, 40, rc0, ri0, fi0))
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))
    st0 = tracking.init_state(rc=[rc0 + 0.3], ri=[ri0],
                              fc=[F_CA + FCAID * fi0], fi=[fi0 + 15.0])
    st, log = tracking.track_chunk(st0, raw, tab, FS, FCAID)
    # Doppler pulled back to truth, code phase tracked
    assert abs(float(st.fi[0]) - fi0) < 4.0
    iP = np.asarray(log.iP)[:, 0]
    assert np.abs(iP[-10:]).min() > 0.5 * np.abs(iP[-10:]).max()


def test_track_chunk_batched_matches_sequential():
    """batch_k predictor-corrector tracking (k windows correlated per scan
    body with frozen-rate phase prediction, per-ms measurement updates)
    must follow the 1 ms loop's trajectory: within-batch rates are frozen,
    so agreement is to the size of one batch's rate correction, and the
    closed loop converges to the same steady state."""
    prn, rc0, ri0, fi0 = 5, 250.0, 0.4, 900.0
    raw = jnp.asarray(_make_blocks(prn, 40, rc0, ri0, fi0))
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))
    st0 = tracking.init_state(rc=[rc0 + 0.2], ri=[ri0],
                              fc=[F_CA + FCAID * fi0], fi=[fi0 + 10.0])
    st1, log1 = tracking.track_chunk(st0, raw, tab, FS, FCAID)
    stb, logb = tracking.track_chunk_batched(st0, raw, tab, FS, FCAID,
                                             batch_k=4)
    # same shapes/log contract as track_chunk
    assert np.asarray(logb.iP).shape == np.asarray(log1.iP).shape
    # converged to the same steady state: Doppler and code phase agree
    assert abs(float(stb.fi[0]) - float(st1.fi[0])) < 2.0
    assert abs(float(stb.rc[0]) - float(st1.rc[0])) < 0.05
    assert int(stb.cp[0]) == int(st1.cp[0])
    # prompt power comparable (locked in both)
    p1 = np.abs(np.asarray(log1.iP)[-8:, 0]).mean()
    pb = np.abs(np.asarray(logb.iP)[-8:, 0]).mean()
    assert pb > 0.8 * p1
    # nav-bit sign stream identical over the locked tail
    s1 = np.asarray(log1.signs)[20:, 0]
    sb = np.asarray(logb.signs)[20:, 0]
    np.testing.assert_array_equal(s1, sb)


def test_track_chunk_unroll_invariant():
    """lax.scan unroll must not change the tracking
    trajectory. The carry dependency sequences the per-window math
    identically, but XLA may fuse/reassociate the unrolled bodies
    differently, so outputs agree to f32-ulp class, not bit-exactly."""
    prn, rc0, ri0, fi0 = 5, 250.0, 0.4, 900.0
    raw = jnp.asarray(_make_blocks(prn, 30, rc0, ri0, fi0))
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))
    st0 = tracking.init_state(rc=[rc0 + 0.2], ri=[ri0],
                              fc=[F_CA + FCAID * fi0], fi=[fi0 + 10.0])
    st1, log1 = tracking.track_chunk(st0, raw, tab, FS, FCAID, unroll=1)
    st8, log8 = tracking.track_chunk(st0, raw, tab, FS, FCAID, unroll=8)
    for a, b in zip(log1, log8):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-2)
    for a, b in zip(st1, st8):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-2)


def test_correlate_step_onehot_path_matches_gather_path(monkeypatch):
    """Full _correlate_step parity between the one-hot and gather
    replica strategies — segment sums, not just replicas."""
    prn, rc0, ri0, fi0 = 9, 321.5, 0.3, -650.0
    raw = _make_blocks(prn, 1, rc0, ri0, fi0)[0]
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))
    st = tracking.init_state(rc=[rc0 + 0.2], ri=[ri0],
                             fc=[F_CA + FCAID * fi0], fi=[fi0])
    time_idc = jnp.asarray((np.arange(S) / FS).astype(np.float32))
    rr = jnp.asarray(raw.real.astype(np.float32))
    ri_ = jnp.asarray(raw.imag.astype(np.float32))

    outs = {}
    for name, fn in (("gather", tracking._epl_gather),
                     ("onehot", tracking._epl_onehot)):
        monkeypatch.setattr(
            tracking, "_epl_replicas",
            lambda t, b, p, _f=fn, **kw: _f(t, b, p))
        e_s, p_s, l_s, ncp = tracking._correlate_step(
            st, rr, ri_, tab, time_idc, FS)
        outs[name] = (np.asarray(e_s), np.asarray(p_s), np.asarray(l_s),
                      np.asarray(ncp))
    for a, b in zip(outs["gather"], outs["onehot"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-2)


def test_coherent_mode_matches_1ms_loop():
    """coh_ms=4 coherent predetection integration: same capture, same
    starting offset — the 4 ms loop must pull in to the same Doppler /
    code phase as the 1 ms loop (both vs truth) and hold lock."""
    prn, rc0, ri0, fi0 = 7, 500.0, 0.1, 1234.0
    raw = _make_blocks(prn, 1000, rc0, ri0, fi0)       # [1000, S]
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))
    st0 = tracking.init_state(rc=[rc0 + 0.3], ri=[ri0],
                              fc=[F_CA + FCAID * (fi0 + 25)],
                              fi=[fi0 + 25.0])

    _, log1 = tracking.track_chunk(st0, jnp.asarray(raw), tab, FS, FCAID)
    # at a 4 ms update period the PLL alone cycle-slips on a 25 Hz initial
    # error; FLL-assisted pull-in (range +/-125 Hz at m=4) is the
    # realistic coherent-mode configuration
    loops4 = tracking.LoopConfig(order=2, bn_code=2.0, bn_carr=12.0,
                                 bn_carr_freq=3.0)
    _, log4 = tracking.track_chunk(
        st0, jnp.asarray(raw.reshape(250, 4 * S)), tab, FS, FCAID,
        loops4, coh_ms=4)

    fi1 = np.asarray(log1.fi)[-50:, 0].mean()
    fi4 = np.asarray(log4.fi)[-13:, 0].mean()
    assert abs(fi1 - fi0) < 2.0, fi1
    assert abs(fi4 - fi0) < 2.0, fi4

    # code phase at update u (start of window) is rc0 + (fc0-F_CA)*4e-3*u
    rc4 = np.asarray(log4.rc)[:, 0]
    u = np.arange(250)
    fc0 = F_CA + FCAID * fi0
    rc_true = np.mod(rc0 + (fc0 - F_CA) * 4e-3 * u, L_CA)
    err = np.abs(((rc4 - rc_true) + L_CA / 2) % L_CA - L_CA / 2)
    assert np.mean(err[-50:]) < 0.05, np.mean(err[-50:])
    assert int(np.asarray(log4.lock)[-1, 0]) == 1
    # C/N0 estimate stays in band with the longer predetection time (the
    # 20-update variance ring reads a few dB lower at m>1 because loop
    # jitter decorrelates over the longer ring span — estimator class,
    # not a scaling bug; the m-invariance of the formula is checked in
    # expectation against the reference's snrmeter math)
    assert 30.0 < float(np.asarray(log4.snr)[-1, 0]) < 55.0
    # cp bookkeeping: total completed code periods must agree (1 period/ms)
    cp1 = int(np.asarray(log1.cp)[-1, 0] + np.asarray(log1.ncp)[-1, 0])
    cp4 = int(np.asarray(log4.cp)[-1, 0] + np.asarray(log4.ncp)[-1, 0])
    assert cp1 == cp4, (cp1, cp4)


def test_coherent_mode_recovers_nav_bits():
    """coh_ms=5 windows span nav-bit flips; the per-code-period polarity
    chain must still produce the exact transmitted cp_sign stream."""
    prn, rc0, fi0 = 3, 100.0, -800.0
    rng = np.random.default_rng(11)
    bits = np.where(rng.standard_normal(80) > 0, 1.0, -1.0)
    raw = _make_blocks(prn, 1000, rc0, 0.0, fi0, cn0=50.0, bits=bits, seed=2)
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))

    st = tracking.init_state(rc=[rc0], ri=[0.0], fc=[F_CA + FCAID * fi0],
                             fi=[fi0])
    loops = tracking.LoopConfig(order=2, bn_code=2.0, bn_carr=10.0)
    _, log = tracking.track_chunk(
        st, jnp.asarray(raw.reshape(200, 5 * S)), tab, FS, FCAID,
        loops, coh_ms=5)

    ncp = np.asarray(log.ncp)[:, 0]
    signs = np.asarray(log.signs)[:, 0, :]
    cp_sign = []
    for t in range(200):
        for j in range(ncp[t]):
            cp_sign.append(signs[t, j])
    cp_sign = np.array(cp_sign)

    n_cp = len(cp_sign)
    assert abs(n_cp - 1000) <= 1, n_cp
    cps = np.arange(n_cp)
    true_bits = bits[np.clip(cps // 20, 0, len(bits) - 1)]
    agree = np.mean(cp_sign[200:900] == -true_bits[200:900])
    disagree = np.mean(cp_sign[200:900] == true_bits[200:900])
    assert max(agree, disagree) > 0.995, (agree, disagree)


def test_coherent_mode_weak_signal_gain():
    """At 27 dB-Hz the 1 ms / Bn 40 Hz product loop loses phase lock;
    8 ms predetection integration (+9 dB discriminator SNR) with scaled
    bandwidths tracks through — the sensitivity win of the mode."""
    prn, rc0, fi0 = 12, 250.0, 900.0
    raw = _make_blocks(prn, 2000, rc0, 0.0, fi0, cn0=27.0, seed=9)
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))
    st0 = tracking.init_state(rc=[rc0], ri=[0.0], fc=[F_CA + FCAID * fi0],
                              fi=[fi0])

    _, log1 = tracking.track_chunk(st0, jnp.asarray(raw), tab, FS, FCAID)
    loops8 = tracking.LoopConfig(order=2, bn_code=1.0, bn_carr=6.0)
    _, log8 = tracking.track_chunk(
        st0, jnp.asarray(raw.reshape(250, 8 * S)), tab, FS, FCAID,
        loops8, coh_ms=8)

    fi_err_1 = abs(np.asarray(log1.fi)[-200:, 0].mean() - fi0)
    fi_err_8 = abs(np.asarray(log8.fi)[-25:, 0].mean() - fi0)
    assert fi_err_8 < 2.0, fi_err_8
    # Kaplan comparator margin positive on average (the binary flag needs
    # 30 consecutive in-lock updates and flickers this close to threshold)
    assert np.asarray(log8.lockval)[-25:, 0].mean() > 0.0
    # the 1 ms wide loop wanders: either lost lock or >2x the freq error
    lock1 = int(np.asarray(log1.lock)[-1, 0])
    assert lock1 == 0 or fi_err_1 > 2.0 * fi_err_8, (lock1, fi_err_1,
                                                     fi_err_8)


# constfold decides half-chip boundaries in exact arithmetic where the
# f32-base paths round: ~1 sample of 2500 per window takes the other tap,
# a few 1e-3 of the prompt after loop feedback
@pytest.mark.parametrize("strategy, rtol", [("factored", 1e-4),
                                            ("constfold", 5e-3)])
def test_forced_replica_strategies_agree(strategy, rtol):
    """The gather-free replica constructions, forced by name, track like
    the default gather path (same segment-sum contract)."""
    prn, rc0, fi0 = 3, 100.0, 500.0
    raw = jnp.asarray(_make_blocks(prn, 10, rc0, 0.1, fi0))
    tab = jnp.asarray(ca_table([prn]).astype(np.float32))
    st0 = tracking.init_state(rc=[rc0], ri=[0.1], fc=[F_CA + FCAID * fi0],
                              fi=[fi0])
    _, la = tracking.track_chunk(st0, raw, tab, FS, FCAID,
                                 strategy="gather")
    _, lb = tracking.track_chunk(st0, raw, tab, FS, FCAID,
                                 strategy=strategy)
    np.testing.assert_allclose(np.asarray(la.iP), np.asarray(lb.iP),
                               rtol=rtol, atol=1e-2)
