"""Coverage of secondary modes: TCP source, weighted estimator, full EKF,
duty-cycled windows, arg_pi4 format, Nms bit folding, grid variants."""

import copy

import numpy as np
import pytest

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu.io.netsource import FileReplayServer, TcpSampleSource
from navlab_dpe_sdr_tpu.io.rawfile import (DTYPE_ARG_PI4, DTYPE_IQ16,
                                           SampleFile)
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.models.dpe import DPEConfig, DPEReceiver
from navlab_dpe_sdr_tpu.models.grid import (arthur_grid, load_grid_csv,
                                            make_grid, uniform_grid)

FS = 2.5e6


@pytest.fixture(scope="module")
def scene():
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 14
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr


def test_tcp_sample_source(tmp_path, scene):
    samples, hand, arr = scene
    path = tmp_path / "cap.dat"
    samples[:50000 * 3].tofile(path)
    srv = FileReplayServer(str(path))
    with TcpSampleSource("127.0.0.1", srv.port, block_samples=50000) as src:
        for _ in range(3):
            blk = src.next_block()
            assert blk is not None and blk.shape == (50000, 2)
        assert src.next_block() is None
    srv.join()
    # content check on first block
    first = samples[:50000]
    np.testing.assert_array_equal(
        np.stack([first["i"], first["q"]], axis=1),
        np.frombuffer(path.read_bytes()[:200000], np.int16).reshape(50000, 2))

    # preferred constructor: native ring-buffered TCP source when built
    from navlab_dpe_sdr_tpu.io.netsource import open_tcp_source
    srv2 = FileReplayServer(str(path))
    with open_tcp_source("127.0.0.1", srv2.port, block_samples=50000) as src:
        blk = src.next_block()
        np.testing.assert_array_equal(
            blk, np.stack([first["i"], first["q"]], axis=1))
    srv2.join()


def test_weighted_mean_estimator(scene):
    samples, hand, arr = scene
    rf = SampleFile(samples=samples.copy(), fs=FS)
    cfg = DPEConfig(use_argmax=False)   # reference receiver.py:254-320
    rx = DPEReceiver(rf, copy.deepcopy(hand), config=cfg,
                     eph=copy.deepcopy(arr))
    fixes = rx.run(6)
    errs = [np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3]) for f in fixes]
    # the score-weighted mean is biased toward the grid centroid but must
    # stay in the neighborhood
    assert np.median(errs) < 40.0, errs


def test_weighted_mean_device_matches_host(scene):
    """The device-side streaming weighted-mean estimator (batched /
    integrated modes; reference BCM_PosMeas/BCM_VelMeas atomicAdd
    estimator, batchcorrmanifold.cu:348-784) must match the per-block
    host path (full-surface fetch + f64 mean) at lookahead=1, where the
    batched sequencing is identical to run()."""
    samples, hand, arr = scene
    cfg = DPEConfig(use_argmax=False)
    rx_h = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), config=cfg,
                       eph=copy.deepcopy(arr))
    rx_h.run(5)
    rx_d = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), config=copy.deepcopy(cfg),
                       eph=copy.deepcopy(arr))
    rx_d.run_batched(5, lookahead=1)
    assert len(rx_h.fixes) == len(rx_d.fixes) == 5
    for fh, fd in zip(rx_h.fixes, rx_d.fixes):
        np.testing.assert_allclose(fd.x_ecef, fh.x_ecef, atol=0.05)

    # integrated mode accepts the weighted estimator too and lands in the
    # same neighborhood as its argmax counterpart
    rx_i = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), config=copy.deepcopy(cfg),
                       eph=copy.deepcopy(arr))
    rx_i.run_integrated(2, blocks_per_fix=4)
    errs = [np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3])
            for f in rx_i.fixes]
    assert np.median(errs) < 40.0, errs

    # coherent-grouped batched mode + weighted estimator compose: one
    # weighted-mean fix per K-block group
    rx_g = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), config=copy.deepcopy(cfg),
                       eph=copy.deepcopy(arr))
    rx_g.run_batched(8, lookahead=4, group_k=4)
    assert len(rx_g.fixes) == 2
    errs_g = [np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3])
              for f in rx_g.fixes]
    assert np.median(errs_g) < 40.0, errs_g


def test_bench_parity_block(scene):
    """bench.py's on-device oracle runback (factorized-vs-direct
    correlator) on CPU: tight agreement and no crashes — the GPU run
    reports the same block in the bench JSON."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    samples, hand, arr = scene
    from navlab_dpe_sdr_tpu.models.grid import spread_grid
    out = bench._parity_block(samples[:50000 * 2], copy.deepcopy(hand),
                              copy.deepcopy(arr), spread_grid())
    assert out["corr_flip_equal"] and out["corr_argmax_equal"], out
    assert out["corr_code_max_rel"] < 1e-4, out
    assert out["corr_carr_max_rel"] < 1e-4, out


def test_full_ekf_mode(scene):
    samples, hand, arr = scene
    rf = SampleFile(samples=samples.copy(), fs=FS)
    cfg = DPEConfig(ekf_mode="full")
    rx = DPEReceiver(rf, copy.deepcopy(hand), config=cfg,
                     eph=copy.deepcopy(arr))
    fixes = rx.run(10)
    errs = [np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3]) for f in fixes]
    assert np.median(errs[3:]) < 20.0, errs
    # covariance contracts from the prior but stays floored by the q_pos
    # random-walk term (it must NOT collapse toward zero — that was the
    # round-1 overconfidence failure)
    assert np.trace(rx.ekf.P) < 300.0
    assert np.trace(rx.ekf.P[:4, :4]) > 1.0


def test_duty_cycled_dpe(scene):
    """T_big > T: process 20 ms out of every 40 ms (rawfile.py:176-182)."""
    samples, hand, arr = scene
    rf = SampleFile(samples=samples.copy(), fs=FS)
    rx = DPEReceiver(rf, copy.deepcopy(hand), eph=copy.deepcopy(arr),
                     config=DPEConfig(T=0.02))
    rf.set_block(0.02, 0.04, verbose=False)
    fixes = rx.run(5)   # consumes 5 * 40 ms
    errs = [np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3]) for f in fixes]
    assert np.median(errs) < 25.0, errs
    assert rf.sample_pos == hand.bytes_read // 4 + 5 * int(0.04 * FS)


def test_arg_pi4_format(tmp_path):
    """Phase-quantized byte capture format (rawfile.py:152-154)."""
    rng = np.random.default_rng(0)
    phases = rng.integers(-4, 4, 10000).astype(np.int8)
    arr = np.empty(10000, DTYPE_ARG_PI4)
    arr["arg_pi4"] = phases
    p = tmp_path / "p.dat"
    arr.tofile(p)
    rf = SampleFile(str(p), fs=2.5e6, datatype=DTYPE_ARG_PI4)
    rf.set_block(0.001, 0.001, verbose=False)
    blk = rf.read_block()
    np.testing.assert_allclose(
        blk[:10], np.exp(1j * phases[:10] * np.pi / 4.0), rtol=1e-12)


def test_nms_correlation_folding(scene):
    from navlab_dpe_sdr_tpu.models.scalar import ScalarReceiver
    samples, hand, arr = scene
    rf = SampleFile(samples=samples.copy(), fs=FS)
    rx = ScalarReceiver(rf, hand.prn_list)
    rx.acquire(verbose=False)
    rx.track(120)
    rx.set_ephemerides({e.prn: e for e in arr.ephs})
    prn = hand.prn_list[0]
    iE, iP, iL, qE, qP, qL = rx.get_nms_correlation(prn, ms=120, n=40)
    assert iP.shape == (40,)
    # after folding, the prompt signs must be consistent (no bit flips left)
    strong = np.abs(iP) > 3 * np.median(np.abs(qP))
    assert np.all(np.sign(iP[strong]) == np.sign(iP[strong][0]))


def test_grid_variants_and_csv(tmp_path):
    g1 = make_grid("uniform", n=9)
    assert g1.n_pos == 9 ** 4
    g2 = arthur_grid(n=9, pos_spacing=2.0)
    assert g2.n_pos == 9 ** 4
    # border spacing 3x the interior
    ax = np.unique(g2.d_enu[:, 0])
    d = np.diff(ax)
    assert d.max() > 2.5 * d.min()

    rows = np.random.default_rng(1).standard_normal((100, 3)) * 50
    p = tmp_path / "grid.csv"
    np.savetxt(p, rows, delimiter=",")
    g3 = load_grid_csv(str(p))
    assert g3.n_pos == 100
    np.testing.assert_allclose(g3.d_enu, rows, rtol=1e-12)


def test_reference_parity_linear_interp(scene):
    """interp='linear' (the reference's exact chord estimator) must run and
    hold the solution; its known integer-snap stickiness keeps corrections
    coarse, so only require boundedness (see ops/dpe.py discussion)."""
    samples, hand, arr = scene
    rf = SampleFile(samples=samples.copy(), fs=FS)
    rx = DPEReceiver(rf, copy.deepcopy(hand),
                     config=DPEConfig(interp="linear"),
                     eph=copy.deepcopy(arr))
    fixes = rx.run(8)
    errs = [np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3]) for f in fixes]
    assert np.max(errs) < 60.0, errs


def test_alpha_smoother_beats_passthrough(scene):
    """ekf_mode='alpha' must cut the fix scatter well below passthrough."""
    samples, hand, arr = scene
    results = {}
    for mode in ("passthrough", "alpha"):
        rf = SampleFile(samples=samples.copy(), fs=FS)
        rx = DPEReceiver(rf, copy.deepcopy(hand),
                         config=DPEConfig(ekf_mode=mode, ekf_alpha=0.3),
                         eph=copy.deepcopy(arr))
        rx.run(14)
        errs = [np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3])
                for f in rx.fixes]
        results[mode] = np.median(errs[6:])
    assert results["alpha"] < 8.0, results
    assert results["alpha"] < results["passthrough"] + 1e-9, results


def test_auto_window_sizing_and_equivalence(scene):
    """Grid-adaptive score windows: sized from the grid geometry, exact
    (identical fixes vs the fixed worst-case widths), and guarded against
    too-narrow explicit widths (which would score clamped window edges)."""
    from navlab_dpe_sdr_tpu.ops.dpe import auto_windows
    from navlab_dpe_sdr_tpu.models.grid import spread_grid

    g = spread_grid()
    cw, vw = auto_windows(g.d_enu, g.dt_m, g.dv_enu, g.dtdot, FS, 524288)
    assert cw == 12 and vw == 36       # < the fixed (16, 48) worst case
    g8 = spread_grid(scale=8.0)
    cw8, _ = auto_windows(g8.d_enu, g8.dt_m, g8.dv_enu, g8.dtdot, FS, 524288)
    assert cw8 > 16                    # fixed 16 would clamp at scale 8

    samples, hand, arr = scene
    fixes = {}
    for label, cfg in (("auto", DPEConfig()),
                       ("wide", DPEConfig(code_win=16, carr_win=48))):
        rf = SampleFile(samples=samples.copy(), fs=FS)
        rx = DPEReceiver(rf, copy.deepcopy(hand), config=cfg,
                         eph=copy.deepcopy(arr))
        if label == "auto":
            assert (rx.code_win, rx.carr_win) == (12, 36)
        rx.run(6)
        fixes[label] = np.stack([f.x_ecef for f in rx.fixes])
    # same grid argmaxes -> same fixes (scoring reads identical values
    # through either window; only the f32 window-local index origin moves)
    np.testing.assert_allclose(fixes["auto"], fixes["wide"],
                               rtol=0, atol=1e-6)

    with pytest.raises(ValueError, match="too narrow"):
        DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                    copy.deepcopy(hand),
                    config=DPEConfig(code_win=8, carr_win=48),
                    eph=copy.deepcopy(arr))


def test_prepare_batch_matches_prepare_block(scene):
    """_prepare_batch (vectorized [N, C] host prep) must reproduce the
    sequential _prepare_block chain: same prep tuples, same end-of-batch
    receiver state."""
    samples, hand, arr = scene
    rxs = []
    for _ in range(2):
        rf = SampleFile(samples=samples.copy(), fs=FS)
        rxs.append(DPEReceiver(rf, copy.deepcopy(hand),
                               eph=copy.deepcopy(arr)))
    rx_v, rx_s = rxs
    n = 7
    preps_v = rx_v._prepare_batch(n)
    preps_s = [rx_s._prepare_block() for _ in range(n)]
    for k, (pv, ps) in enumerate(zip(preps_v, preps_s)):
        np.testing.assert_allclose(pv[0], ps[0], rtol=0, atol=2e-4,
                                   err_msg=f"fpk block {k}")
        np.testing.assert_array_equal(pv[1], ps[1],
                                      err_msg=f"ipk block {k}")
        np.testing.assert_allclose(pv[2], ps[2], rtol=0, atol=1e-12)
        assert pv[3] == pytest.approx(ps[3], abs=1e-9)   # rx_time
        assert pv[4] == ps[4]                            # mc
        np.testing.assert_allclose(pv[5], ps[5], rtol=0, atol=1e-9)
    for f in ("cp", "rc", "ri", "fi", "fc"):
        np.testing.assert_allclose(getattr(rx_v, f), getattr(rx_s, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert rx_v.mc == rx_s.mc
    assert rx_v.rx_time == pytest.approx(rx_s.rx_time, abs=1e-9)
