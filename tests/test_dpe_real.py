"""Equivalence tests: real-arithmetic windowed DPE engine vs full-FFT path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1, L_CA, T_CA
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import synth_simple
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_code
from navlab_dpe_sdr_tpu.models.dpe import DPEConfig, DPEReceiver
from navlab_dpe_sdr_tpu.models.grid import spread_grid
from navlab_dpe_sdr_tpu.ops import dpe as dpe_ops
from navlab_dpe_sdr_tpu.ops import dpe_real as dpe_real_ops

FS = 2.5e6
S = 50000
PERIOD = 2500
FPTS = 8 * (1 << 16)


def _run_both(prn, rc, fi, idx_next_val, seed=0):
    fc = F_CA + fi * F_CA / F_L1
    sig = synth_simple(prn, FS, S, rc=rc, ri=0.3, fc=fc, fi=fi,
                       cn0_dbhz=50.0, seed=seed).astype(np.complex64)
    t32 = jnp.asarray((np.arange(S) / FS).astype(np.float32))
    pos_start = np.array([S // 2 - dpe_ops.CODE_WIN // 2], np.int32)
    vel_start = np.array([FPTS // 2 - dpe_ops.CARR_WIN // 2], np.int32)

    # complex/FFT path
    chips = ca_code(prn)[None, :]
    cf0 = jnp.asarray(dpe_ops.nominal_code_fft(chips, FS, S))
    m_int, m_frac = dpe_ops.replica_shift_parts(
        np.array([rc]), np.array([fc - F_CA]), FS, S / FS, S)
    scores = dpe_ops.batch_correlate(
        jnp.asarray(sig), cf0, jnp.asarray(m_int), jnp.asarray(m_frac),
        jnp.asarray([np.int32(idx_next_val)]),
        jnp.asarray([np.float32(fi)]), jnp.asarray([np.float32(0.3)]),
        t32, FPTS)
    cw, vw, _, _ = dpe_ops.extract_windows(
        scores, pos_start + dpe_ops.CODE_WIN // 2,
        vel_start + dpe_ops.CARR_WIN // 2)
    fft_code = np.abs(np.asarray(cw))[0]
    fft_carr = np.abs(np.asarray(vw))[0]

    # real windowed path
    rc_mid = np.mod(rc + (fc - F_CA) * (S / FS / 2.0), L_CA)
    base0 = jnp.asarray((np.arange(PERIOD) / FS * F_CA).astype(np.float32))
    out = dpe_real_ops.windowed_correlate(
        jnp.asarray(sig.real.astype(np.float32)),
        jnp.asarray(sig.imag.astype(np.float32)),
        jnp.asarray(chips.astype(np.float32)), base0,
        jnp.asarray([np.float32(rc_mid)]),
        jnp.asarray([np.int32(idx_next_val)]),
        jnp.asarray([np.float32(fi)]), jnp.asarray([np.float32(0.3)]),
        t32, jnp.asarray(pos_start), jnp.asarray(vel_start),
        FPTS, PERIOD, S // PERIOD)
    real_code = np.asarray(out.code_mag)[0]
    real_carr = np.asarray(out.carr_mag)[0]
    return fft_code, fft_carr, real_code, real_carr, bool(np.asarray(out.flip_used)[0])


def test_real_engine_windows_match_fft():
    fft_code, fft_carr, real_code, real_carr, _ = _run_both(
        9, rc=400.25, fi=1500.0, idx_next_val=S)
    # peak positions identical
    assert abs(int(np.argmax(fft_code)) - int(np.argmax(real_code))) <= 1
    assert abs(int(np.argmax(fft_carr)) - int(np.argmax(real_carr))) <= 1
    # peak magnitudes agree (replica models differ slightly: fractional
    # bandlimited shift vs nearest-chip tiling)
    assert abs(fft_code.max() - real_code.max()) / fft_code.max() < 0.10
    assert abs(fft_carr.max() - real_carr.max()) / fft_carr.max() < 0.10
    # full window shapes correlate strongly
    cc = np.corrcoef(fft_code, real_code)[0, 1]
    assert cc > 0.98, cc
    cv = np.corrcoef(fft_carr, real_carr)[0, 1]
    assert cv > 0.98, cv


def test_real_engine_flip_matches():
    # signal with a nav-bit flip at code period 20
    prn, rc, fi = 6, 250.0, 300.0
    fc = F_CA + fi * F_CA / F_L1
    bits = np.ones(60)
    bits[1:] = -1.0
    sig = synth_simple(prn, FS, S, rc=rc, fc=fc, fi=fi, cn0_dbhz=50.0,
                       bits=bits, seed=3).astype(np.complex64)
    idx_next = int(np.floor((20 * L_CA - rc) * FS / fc)) + 1

    chips = ca_code(prn)[None, :]
    base0 = jnp.asarray((np.arange(PERIOD) / FS * F_CA).astype(np.float32))
    t32 = jnp.asarray((np.arange(S) / FS).astype(np.float32))
    pos_start = np.array([S // 2 - dpe_ops.CODE_WIN // 2], np.int32)
    vel_start = np.array([FPTS // 2 - dpe_ops.CARR_WIN // 2], np.int32)
    rc_mid = np.mod(rc + (fc - F_CA) * 0.01, L_CA)
    out = dpe_real_ops.windowed_correlate(
        jnp.asarray(sig.real.astype(np.float32)),
        jnp.asarray(sig.imag.astype(np.float32)),
        jnp.asarray(chips.astype(np.float32)), base0,
        jnp.asarray([np.float32(rc_mid)]),
        jnp.asarray([np.int32(idx_next)]),
        jnp.asarray([np.float32(fi)]), jnp.asarray([np.float32(0.0)]),
        t32, jnp.asarray(pos_start), jnp.asarray(vel_start),
        FPTS, PERIOD, S // PERIOD)
    assert bool(np.asarray(out.flip_used)[0])
    mag = np.asarray(out.code_mag)[0]
    peak = int(np.argmax(mag))
    assert abs(peak - dpe_ops.CODE_WIN // 2) <= 1.5
    # flipped correlation recovers nearly full coherent amplitude
    assert mag[peak] > 0.8 * 32 * np.sqrt(10 ** 5.0 / FS) * S


def test_real_engine_dpe_converges():
    """Full receiver with the real engine converges like the FFT engine.

    Bounds from a 3-seed sweep of the converged per-block scatter at
    47 dB-Hz: the real engine's 3-tap quadratic interpolation settles to a
    ~10-16 m last-5 median, the FFT engine's linear interpolation to
    ~11-30 m; both start 72 m off.
    """
    from navlab_dpe_sdr_tpu.libgnss import frames
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 10
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([40.0, -55.0, 25.0]))
    errs = {}
    for engine in ("real", "fft"):
        import copy
        rf = SampleFile(samples=samples.copy(), fs=FS)
        rx = DPEReceiver(rf, copy.deepcopy(hand), grid=spread_grid(),
                         config=DPEConfig(engine=engine),
                         eph=copy.deepcopy(arr))
        fixes = rx.run(10)
        errs[engine] = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
                        for f in fixes]
    assert np.median(errs["real"][-5:]) < 20.0, errs["real"]
    assert np.median(errs["fft"][-5:]) < 40.0, errs["fft"]


def test_pipelined_batched_accuracy():
    """pipeline=True (one extra batch of prediction staleness) must converge
    like the synchronous batched mode."""
    from navlab_dpe_sdr_tpu.libgnss import frames
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 18
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    import copy
    rf = SampleFile(samples=samples, fs=FS)
    rx = DPEReceiver(rf, copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr))
    rx.run_batched(18, lookahead=6, pipeline=True)
    errs = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
            for f in rx.fixes]
    assert np.median(errs[-6:]) < 20.0, [round(e, 1) for e in errs]

    # depth-2 pipeline (two batches in flight, two batches of prediction
    # staleness) must also converge
    rx2 = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                      copy.deepcopy(hand), grid=spread_grid(),
                      eph=copy.deepcopy(arr))
    rx2.run_batched(18, lookahead=6, pipeline=True, pipeline_depth=2)
    errs2 = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
             for f in rx2.fixes]
    assert np.median(errs2[-6:]) < 20.0, [round(e, 1) for e in errs2]

    # depth 4 (the r4 bench default: background-fetch drain keeps four
    # dispatches in flight) must also converge at its deeper staleness
    rx3 = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                      copy.deepcopy(hand), grid=spread_grid(),
                      eph=copy.deepcopy(arr))
    rx3.run_batched(18, lookahead=3, pipeline=True, pipeline_depth=4)
    errs3 = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
             for f in rx3.fixes]
    assert np.median(errs3[-6:]) < 25.0, [round(e, 1) for e in errs3]


def test_integrated_dpe_beats_per_block():
    """Noncoherent K-block score integration must reduce fix error below the
    per-block argmax floor."""
    from navlab_dpe_sdr_tpu.libgnss import frames
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 48
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    import copy
    rf = SampleFile(samples=samples, fs=FS)
    rx = DPEReceiver(rf, copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr))
    rx.run_integrated(6, blocks_per_fix=8)
    errs = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
            for f in rx.fixes]
    assert np.median(errs[2:]) < 8.0, errs


def test_newton_refine_batched():
    """refine='newton' in batched mode: the device must return the score
    windows (return_windows=True path) and the ML polish must produce
    sub-grid fixes that still converge."""
    from navlab_dpe_sdr_tpu.libgnss import frames
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 18
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    import copy
    rf = SampleFile(samples=samples, fs=FS)
    rx = DPEReceiver(rf, copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr),
                     config=DPEConfig(refine="newton"))
    rx.run_batched(18, lookahead=6, pipeline=True)
    errs = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
            for f in rx.fixes]
    assert np.median(errs[-6:]) < 20.0, [round(e, 1) for e in errs]
    # the polish moves fixes off the exact grid lattice: ENU offsets of the
    # last fixes must not all be multiples of the 5 m dense spacing
    r = frames.ecef_to_enu_matrix(truth[0:3])
    enu = np.stack([r @ (f.x_ecef[0:3] - truth[0:3]) for f in rx.fixes[-6:]])
    frac = np.minimum(np.mod(np.abs(enu), 5.0), 5.0 - np.mod(np.abs(enu), 5.0))
    assert frac.max() > 1e-3, enu


def test_deep_integration_holds_24dbhz():
    """K=32 on-device integration holds the fix at 24 dB-Hz — ~16 dB below
    where the per-block argmax breaks (SENS_r02: per-block fails at 40,
    K=8 at ~35). The prediction stays exact over the 640 ms batch because
    the per-block host prep solves the code phase at every epoch from the
    frozen state (closed-form geometry, not dead reckoning)."""
    import copy
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=24.0)
    n = 50000 * 64
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    rx = DPEReceiver(SampleFile(samples=samples, fs=FS),
                     copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr))
    rx.run_integrated(2, blocks_per_fix=32)
    errs = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
            for f in rx.fixes]
    # measured 15-19 m at this C/N0 (seed 7); K=8 wobbles 26-64 m here
    assert all(e < 30.0 for e in errs), errs


def test_integrated_coherent_newton_refine():
    """refine='newton' + coherent integration: the summed windows come back
    from the device and the host polish produces finite off-lattice fixes.
    Accuracy caveat (measured): the 3-tap vertex carries ~5-8 m of
    interpolant bias at fs-spaced code taps, so this mode trades absolute
    accuracy for off-lattice smoothness — asserted as a ceiling, not a win
    over the argmax (which pins to 0 m on this on-lattice scenario)."""
    import copy
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=45.0)
    n = 50000 * 16
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    rx = DPEReceiver(SampleFile(samples=samples, fs=FS),
                     copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr),
                     config=DPEConfig(refine="newton"))
    rx.run_integrated(2, blocks_per_fix=8, coherent=True)
    errs = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
            for f in rx.fixes]
    assert all(e < 12.0 for e in errs), errs
    # the polish must actually move fixes off the 5 m dense lattice
    from navlab_dpe_sdr_tpu.libgnss import frames
    r = frames.ecef_to_enu_matrix(truth[0:3])
    enu = np.stack([r @ (f.x_ecef[0:3] - truth[0:3]) for f in rx.fixes])
    frac = np.minimum(np.mod(np.abs(enu), 5.0), 5.0 - np.mod(np.abs(enu), 5.0))
    assert frac.max() > 1e-3, enu


def test_integrated_mode_holds_weak_signal():
    """At 30 dB-Hz the per-block argmax scatters off (tens of meters); the
    on-device K-block score integration holds the fix — a sensitivity
    capability the reference's fetch-per-block architecture cannot express."""
    import copy
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=30.0)
    n = 50000 * 32
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()

    rx_pb = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                        copy.deepcopy(hand), grid=spread_grid(),
                        eph=copy.deepcopy(arr))
    rx_pb.run(32)
    e_pb = np.median([np.linalg.norm(f.x_ecef[:3] - truth[:3])
                      for f in rx_pb.fixes])

    rx_int = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                         copy.deepcopy(hand), grid=spread_grid(),
                         eph=copy.deepcopy(arr))
    rx_int.run_integrated(4, blocks_per_fix=8)
    e_int = np.median([np.linalg.norm(f.x_ecef[:3] - truth[:3])
                       for f in rx_int.fixes])

    # bounds from a 3-seed sweep: per-block medians 54-73 m, integrated
    # 4-fix medians 22-38 m (sqrt(8) score-noise reduction lands the argmax
    # within a few dense 5 m cells instead of tens of meters off)
    assert e_pb > 30.0, e_pb          # the per-block floor really is broken
    assert e_int < 45.0, e_int        # integration restores the fix
    assert e_int < 0.8 * e_pb, (e_int, e_pb)


def test_coherent_integration():
    """Coherent K-block integration: complex-window sum with data-aided
    nav-bit alignment. At practical C/N0 it matches the noncoherent
    surface-sum accuracy (no squaring-loss headroom at 20 ms blocks —
    measured, incl. with oracle bit signs) while scoring the manifold
    ONCE per fix instead of once per block. Assert: (a) exact fixes at
    high C/N0 (bit alignment survives real 50 bps transitions), (b)
    comparable accuracy to noncoherent at 30 dB-Hz."""
    import copy

    # (a) high C/N0: alignment across real bit flips; fixes pin to truth
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=45.0)
    n = 50000 * 16
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    fixes = {}
    for label, coh in (("coh", True), ("noncoh", False)):
        rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                         copy.deepcopy(hand), grid=spread_grid(),
                         eph=copy.deepcopy(arr))
        rx.run_integrated(2, blocks_per_fix=8, coherent=coh)
        fixes[label] = [f.x_ecef[:3].copy() for f in rx.fixes]
    # a bit-alignment failure partially cancels the coherent sum and throws
    # the argmax tens of meters off (or worse); correct alignment leaves
    # only the usual 1-2-dense-cell (5-11 m) argmax scatter on the
    # bandlimit-rounded correlation apex (4-seed sweep: max 11.2 m). The
    # sharp check is coherent-vs-noncoherent on the SAME capture: the
    # noncoherent sum has no alignment to get wrong, so any alignment
    # error shows as a divergence between the two estimates.
    for c, nc in zip(fixes["coh"], fixes["noncoh"]):
        assert np.linalg.norm(c - truth[:3]) < 15.0, (c, truth[:3])
        assert np.linalg.norm(c - nc) < 12.0, (c, nc)

    # (b) 30 dB-Hz: within 1.5x of the noncoherent error (typically equal)
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=30.0)
    n = 50000 * 32
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    meds = {}
    for label, coh in (("noncoh", False), ("coh", True)):
        rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                         copy.deepcopy(hand), grid=spread_grid(),
                         eph=copy.deepcopy(arr))
        rx.run_integrated(4, blocks_per_fix=8, coherent=coh)
        meds[label] = np.median([np.linalg.norm(f.x_ecef[:3] - truth[:3])
                                 for f in rx.fixes])
    # per-block argmax is broken at this C/N0 (>30 m, see
    # test_integrated_mode_holds_weak_signal); both integration modes
    # restore the fix, with comparable medians (4-sample medians are
    # noisy; the coherent mode's win is cost, not accuracy)
    assert meds["coh"] < 45.0, meds
    assert meds["coh"] < 1.6 * meds["noncoh"] + 5.0, meds


def test_grouped_batched_matches_integrated():
    """group_k coherent grouping inside the batched dispatcher must compute
    exactly what run_integrated(coherent=True) computes: with one group per
    batch (lookahead == group_k == blocks_per_fix) the preps, the complex
    correlate + data-aided coherent sum, and the measurement sequencing are
    identical, so the fixes must match to float tolerance."""
    import copy

    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=45.0)
    n = 50000 * 16
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)

    rx_g = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), grid=spread_grid(),
                       eph=copy.deepcopy(arr))
    rx_g.run_batched(16, lookahead=8, group_k=8)
    rx_i = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), grid=spread_grid(),
                       eph=copy.deepcopy(arr))
    rx_i.run_integrated(2, blocks_per_fix=8, coherent=True)

    assert len(rx_g.fixes) == len(rx_i.fixes) == 2
    for fg, fi_ in zip(rx_g.fixes, rx_i.fixes):
        assert fg.mc == fi_.mc
        np.testing.assert_allclose(fg.x_ecef, fi_.x_ecef, atol=1e-6)
        np.testing.assert_allclose(fg.pos_score, fi_.pos_score, rtol=1e-5)


def test_grouped_batched_throughput_shape_converges():
    """The throughput shape (several groups per dispatch, pipeline=True)
    must converge from a 52 m initial offset like the per-block batched
    mode — one fix per group, steering at batch boundaries."""
    import copy

    from navlab_dpe_sdr_tpu.libgnss import frames

    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 24
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    rx = DPEReceiver(SampleFile(samples=samples, fs=FS),
                     copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr))
    rx.run_batched(24, lookahead=8, group_k=4, pipeline=True)
    assert len(rx.fixes) == 6
    errs = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
            for f in rx.fixes]
    assert np.median(errs[-3:]) < 20.0, [round(e, 1) for e in errs]


def test_grouped_batched_validates_divisibility():
    import copy

    sim, hand, arr = make_scenario(nav_data=True)
    rx = DPEReceiver(SampleFile(samples=np.zeros(50000 * 8, DTYPE_IQ16),
                                fs=FS),
                     copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr))
    with pytest.raises(ValueError, match="group_k"):
        rx.run_batched(8, lookahead=6, group_k=4)


def test_dpe_checkpoint_resume_via_handoff():
    """DPEReceiver.save_handoff is a faithful mid-run checkpoint: stopping
    after 8 blocks and resuming a fresh receiver from the CSV reproduces
    the uninterrupted run's remaining fixes (the reference's handoff
    contract as a DPE-side resume, receiver.py:804-875)."""
    import copy
    import tempfile

    from navlab_dpe_sdr_tpu.io.handoff import read_handoff

    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 16
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)

    rx_full = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                          copy.deepcopy(hand), grid=spread_grid(),
                          eph=copy.deepcopy(arr))
    rx_full.run(16)

    rx_a = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), grid=spread_grid(),
                       eph=copy.deepcopy(arr))
    rx_a.run(8)
    with tempfile.NamedTemporaryFile(suffix=".csv") as f:
        rx_a.save_handoff(f.name)
        h2 = read_handoff(f.name)
    assert h2.bytes_read == 8 * 50000 * 4
    rx_b = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS), h2,
                       grid=spread_grid())
    rx_b.run(8)

    for fa, fb in zip(rx_full.fixes[8:], rx_b.fixes):
        np.testing.assert_allclose(fb.x_ecef, fa.x_ecef, atol=1e-6)


def test_packed_row_indices_exact_above_2e24():
    """Argmax indices ride the packed f32 rows as BITCAST int32: a value
    cast would round indices above 2^24 (dense 75^4 manifolds have 31.6M
    points) and silently decode the wrong grid point."""
    out = dpe_real_ops.RealBlockOut(
        code_mag=jnp.zeros((2, 1, 8)), carr_mag=jnp.zeros((2, 1, 8)),
        flip_used=jnp.zeros((2, 1)))
    pa = jnp.asarray([31640624, 16777217], jnp.int32)   # 75^4-1, 2^24+1
    va = jnp.asarray([31640623, 1], jnp.int32)
    rows = np.asarray(dpe_real_ops._pack_rows(
        out, pa, jnp.zeros(2), va, jnp.zeros(2), return_windows=False))
    pas, vas = dpe_real_ops.unpack_row_indices(rows)
    np.testing.assert_array_equal(pas, [31640624, 16777217])
    np.testing.assert_array_equal(vas, [31640623, 1])
    # the float32 value cast really would have corrupted these
    assert int(np.float32(16777217)) != 16777217


@pytest.mark.parametrize("complex_out", [False, True])
def test_windowed_matches_direct(complex_out):
    """The regression guard promised by windowed_correlate's docstring:
    period-factorized vs direct form, multi-channel, nav-bit boundary at
    {0, mid-period, exact period multiple, S=none} (r2 advisor finding)."""
    prns = [9, 6, 17, 23]
    rcs = [400.25, 250.0, 12.7, 900.9]
    fis = [1500.0, -2200.0, 300.0, -40.0]
    idx_next = np.array([0, 13 * PERIOD + PERIOD // 2, 13 * PERIOD, S],
                        np.int32)
    sig = sum(
        synth_simple(p, FS, S, rc=rc, ri=0.3, fc=F_CA + fi * F_CA / F_L1,
                     fi=fi, cn0_dbhz=50.0,
                     bits=np.where(np.arange(60) < 26, 1.0, -1.0), seed=i)
        for i, (p, rc, fi) in enumerate(zip(prns, rcs, fis))
    ).astype(np.complex64)
    c = len(prns)
    fcs = [F_CA + fi * F_CA / F_L1 for fi in fis]
    rc_mid = np.array([np.mod(rc + (fc - F_CA) * 0.01, L_CA)
                       for rc, fc in zip(rcs, fcs)], np.float32)
    chips = np.stack([ca_code(p) for p in prns]).astype(np.float32)
    base0 = jnp.asarray((np.arange(PERIOD) / FS * F_CA).astype(np.float32))
    t32 = jnp.asarray((np.arange(S) / FS).astype(np.float32))
    pos_start = np.full(c, S // 2 - dpe_ops.CODE_WIN // 2, np.int32)
    vel_start = np.full(c, FPTS // 2 - dpe_ops.CARR_WIN // 2, np.int32)
    args = (jnp.asarray(sig.real.astype(np.float32)),
            jnp.asarray(sig.imag.astype(np.float32)),
            jnp.asarray(chips), base0, jnp.asarray(rc_mid),
            jnp.asarray(idx_next),
            jnp.asarray(np.asarray(fis, np.float32)),
            jnp.asarray(np.full(c, 0.3, np.float32)),
            t32, jnp.asarray(pos_start), jnp.asarray(vel_start),
            FPTS, PERIOD, S // PERIOD)
    fac = dpe_real_ops.windowed_correlate(*args, complex_out=complex_out)
    direct = jax.jit(
        dpe_real_ops._windowed_correlate_direct,
        static_argnames=("carr_fftpts", "period", "n_periods",
                         "complex_out"))(*args, complex_out=complex_out)
    # idx_next == 0 is a degenerate tie: flip and no-flip windows are
    # sign-equal, so the |corr[0]| comparison is numerically tied and the
    # two forms may break it differently — flip/re-im equality is only
    # well-defined on the non-degenerate channels.
    nondeg = idx_next > 0
    np.testing.assert_array_equal(np.asarray(fac.flip_used)[nondeg],
                                  np.asarray(direct.flip_used)[nondeg])
    if complex_out:
        pairs = [("code_re", fac.code_re, direct.code_re, nondeg),
                 ("code_im", fac.code_im, direct.code_im, nondeg),
                 ("carr_re", fac.carr_re, direct.carr_re, nondeg),
                 ("carr_im", fac.carr_im, direct.carr_im, nondeg)]
        code_f = np.hypot(np.asarray(fac.code_re), np.asarray(fac.code_im))
        code_d = np.hypot(np.asarray(direct.code_re),
                          np.asarray(direct.code_im))
        pairs += [("code_abs", code_f, code_d, slice(None)),
                  ("carr_abs",
                   np.hypot(np.asarray(fac.carr_re), np.asarray(fac.carr_im)),
                   np.hypot(np.asarray(direct.carr_re),
                            np.asarray(direct.carr_im)), slice(None))]
    else:
        pairs = [("code_mag", fac.code_mag, direct.code_mag, slice(None)),
                 ("carr_mag", fac.carr_mag, direct.carr_mag, slice(None))]
        code_f, code_d = np.asarray(fac.code_mag), np.asarray(direct.code_mag)
    for name, a, b, sel in pairs:
        a, b = np.asarray(a)[sel], np.asarray(b)[sel]
        scale = np.abs(b).max(axis=1, keepdims=True)
        rel = np.abs(a - b) / scale
        assert rel.max() < 5e-3, (name, rel.max())
    np.testing.assert_array_equal(np.argmax(code_f, axis=1),
                                  np.argmax(code_d, axis=1))


def test_windowed_nonzero_time_origin():
    """A time vector starting mid-file (t0 != 0, io/rawfile.py samp_idc/fs)
    must produce the same windows as the direct form — pins the
    origin-consistent sliver/twiddle phase derivation."""
    prn, rc, fi = 6, 250.0, 300.0
    fc = F_CA + fi * F_CA / F_L1
    bits = np.where(np.arange(60) < 26, 1.0, -1.0)
    sig = synth_simple(prn, FS, S, rc=rc, fc=fc, fi=fi, cn0_dbhz=50.0,
                       bits=bits, seed=3).astype(np.complex64)
    idx_next = int(np.floor((20 * L_CA - rc) * FS / fc)) + 1
    t0_samp = 7 * S  # 7 blocks into the file
    t32 = jnp.asarray(((t0_samp + np.arange(S)) / FS).astype(np.float32))
    chips = ca_code(prn)[None, :].astype(np.float32)
    base0 = jnp.asarray((np.arange(PERIOD) / FS * F_CA).astype(np.float32))
    pos_start = np.array([S // 2 - dpe_ops.CODE_WIN // 2], np.int32)
    vel_start = np.array([FPTS // 2 - dpe_ops.CARR_WIN // 2], np.int32)
    rc_mid = np.mod(rc + (fc - F_CA) * 0.01, L_CA)
    args = (jnp.asarray(sig.real.astype(np.float32)),
            jnp.asarray(sig.imag.astype(np.float32)),
            jnp.asarray(chips), base0,
            jnp.asarray([np.float32(rc_mid)]),
            jnp.asarray([np.int32(idx_next)]),
            jnp.asarray([np.float32(fi)]),
            jnp.asarray([np.float32(0.0)]),
            t32, jnp.asarray(pos_start), jnp.asarray(vel_start),
            FPTS, PERIOD, S // PERIOD)
    fac = dpe_real_ops.windowed_correlate(*args)
    direct = jax.jit(
        dpe_real_ops._windowed_correlate_direct,
        static_argnames=("carr_fftpts", "period", "n_periods"))(*args)
    assert bool(np.asarray(fac.flip_used)[0]) == bool(
        np.asarray(direct.flip_used)[0])
    for name in ("code_mag", "carr_mag"):
        a = np.asarray(getattr(fac, name))
        b = np.asarray(getattr(direct, name))
        rel = np.abs(a - b) / np.abs(b).max()
        assert rel.max() < 5e-3, (name, rel.max())
    assert int(np.argmax(np.asarray(fac.code_mag)[0])) == int(
        np.argmax(np.asarray(direct.code_mag)[0]))
