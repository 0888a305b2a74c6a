"""Multi-receiver fleet: parallel tracking + millisecond time alignment."""

import numpy as np
import pytest

from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.models.fleet import ReceiverFleet

FS = 2.5e6


def test_fleet_tracks_and_aligns():
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 40  # 0.8 s
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)

    # two "USRPs": the same scene, the second starts 7 ms later
    rf_a = SampleFile(samples=samples.copy(), fs=FS)
    rf_b = SampleFile(samples=samples[int(0.007 * FS):].copy(), fs=FS)
    fleet = ReceiverFleet([rf_a, rf_b], hand.prn_list)

    fleet.acquire()
    fleet.track(400, parallel=True)

    # seed ephemerides (too short a capture to decode live). Each receiver's
    # cp counting starts at its own first sample, so the anchor cp shifts by
    # the capture offset (live decode would produce exactly this).
    import copy
    for rx, cp_shift in zip(fleet.receivers, (0.0, -7.0)):
        ephs = {}
        for e in arr.ephs:
            e2 = copy.deepcopy(e)
            e2.cp_timestamp += cp_shift
            ephs[e2.prn] = e2
        rx.set_ephemerides(ephs)

    offsets = fleet.align()
    # rx_a leads by ~7 ms -> it must be advanced ~7 blocks
    assert abs(int(offsets[0]) - 7) <= 1, offsets
    assert offsets[1] <= 1

    t_after = [s[0] for s in fleet.nav_solutions()]
    assert abs(t_after[0] - t_after[1]) < 1.5e-3


def test_live_fleet_two_radios_shared_clock():
    """Two wall-clock-paced SimulatedRadios (same scene, second radio's
    receiver clock 7 ms late) on one MultiSource clock, driven LIVE
    through acquire -> track -> align -> per-receiver DPE (r4 verdict
    item #5). Asserts the flow contract — alignment, fix agreement
    within grid noise, complete delivery accounting — not wall-clock
    budgets (CI boxes contend)."""
    import copy

    from navlab_dpe_sdr_tpu.io.frontend import (MultiSource,
                                                RadioSyncConfig,
                                                SimulatedRadio)
    from navlab_dpe_sdr_tpu.models.grid import spread_grid

    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 95  # 1.9 s
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)

    srcs = [
        SimulatedRadio(samples.copy(), fs=FS, block_samples=2500),
        SimulatedRadio(samples.copy(), fs=FS, block_samples=2500,
                       start_byte=int(0.007 * FS) * 4),
    ]
    multi = MultiSource(srcs, RadioSyncConfig(setup_time_s=0.05))
    fleet = ReceiverFleet.from_live(multi, hand.prn_list, fs=FS,
                                    max_seconds=2.0, timeout_s=60.0)
    try:
        fleet.acquire()
        fleet.track(1400, parallel=True)   # full loop pull-in

        # capture too short to decode live — seed anchors in each
        # receiver's OWN cp frame: the scenario anchors assume cp=1000 at
        # scenario sample 0 (make_scenario), fresh receivers count cp
        # from 0 at their first sample, and radio 2's first sample is
        # 7 ms into the scenario
        for rx, cp_shift in zip(fleet.receivers, (-1000.0, -1007.0)):
            ephs = {}
            for e in arr.ephs:
                e2 = copy.deepcopy(e)
                e2.cp_timestamp += cp_shift
                ephs[e2.prn] = e2
            rx.set_ephemerides(ephs)

        offsets = fleet.align()
        assert abs(int(offsets[0]) - 7) <= 1, offsets
        assert offsets[1] <= 1

        dpes = fleet.run_dpe(5, grid=spread_grid(), parallel=True)
        meds = [np.median(np.stack([f.x_ecef[:3] for f in d.fixes]), 0)
                for d in dpes]
        spread = float(np.linalg.norm(meds[1] - meds[0]))
        assert spread < 25.0, spread                  # grid-noise class
        for d in dpes:
            err = np.linalg.norm(
                np.asarray(d.fixes[-1].x_ecef[:3]) - hand.x_ecef[:3])
            assert err < 40.0, err

        stats = fleet.live_stats()
        assert all(s["delivered_s"] > 0.5 for s in stats), stats
        # both consumers saw a monotone live edge; lag accounting populated
        assert all(s["lag_max_s"] >= 0.0 for s in stats)
    finally:
        multi.close()
