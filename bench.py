"""Benchmark: end-to-end DPE real-time factor on the demo-equivalent scenario.

Runs the full DPE receiver (host f64 bookkeeping + fused GPU device step)
over an in-memory synthetic 2.5 MHz / 8-PRN capture with the reference's
default 25^4 + 25^4 spread grid, and reports the real-time factor
(processed-signal seconds per wall second).

Variance protocol: after one warm pass per jit signature, the full
two-segment run is
repeated NAVLAB_BENCH_REPEATS (default 3) times with a fresh receiver
over the identical blocks; the headline value is the MEDIAN per-pass rtf
and the JSON carries min/max spread for it, the first-200 segment, and
the per-chunk scalar-tracking rtf.

Also reports cold-start time-to-first-fix: acquire
8 PRNs -> closed-loop track -> LNAV ephemeris decode -> handoff -> first
DPE fix, wall-clock with warm jits (compilation is a cached one-time
deployment cost) plus the signal seconds consumed — the
reference's actual usage sequence (1_Data_reduct_scalar.py:35-108 +
3_Data_reduct_dp.py:76-195).

Baseline: the reference CUDARecv targets 1.0x real time on a Jetson TX2
(20 ms budget per block, BASELINE.md); vs_baseline is therefore the factor
itself.

Needs a GPU and exits nonzero without one. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...}.
"""

import json
import sys
import time

import numpy as np


def main(argv=None):
    import os

    import jax

    from navlab_dpe_sdr_tpu.device import select_device, use_compile_cache
    select_device("gpu")
    use_compile_cache()
    argv = sys.argv[1:] if argv is None else list(argv)

    from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu.models.dpe import DPEReceiver
    from navlab_dpe_sdr_tpu.models.grid import spread_grid

    # default: the full demo-equivalent pass (45 s of signal = 2250 blocks,
    # BASELINE.md demo-dataset row); pass a block count for a quick run
    n_blocks = int(argv[0]) if len(argv) > 0 else 2250
    lookahead = int(argv[1]) if len(argv) > 1 else 50
    # fixes come at 50 Hz (per-block argmax) for the first 200 blocks —
    # the round-over-round comparison segment — then at 10 Hz via
    # coherent K-block grouping (complex windows summed on device before
    # manifold scoring: same correlation work per sample, 1/K the
    # manifold-scoring traffic, equal-or-better fix accuracy; see
    # ops/dpe_real.dpe_batch_blocks group_k)
    group_k = int(argv[2]) if len(argv) > 2 else 5
    # dispatched batches kept in flight (run_batched pipeline_depth;
    # staleness depth*lookahead*T; dynamics-sensitive runs use per-block
    # mode or smaller depth)
    depth = int(argv[3]) if len(argv) > 3 else 4

    # run_batched requires group_k | lookahead and group_k | segment-2
    # length; repair odd argv combinations up front (before sizing the
    # capture) instead of crashing after the timed work
    import math
    if group_k > 1 and lookahead % group_k:
        gk = math.gcd(group_k, lookahead)
        print(f"# group_k {group_k} does not divide lookahead {lookahead}; "
              f"using group_k={gk}", file=sys.stderr)
        group_k = max(1, gk)
    n_short = min(200, n_blocks)
    rem = (n_blocks - n_short) % group_k if group_k > 1 else 0
    if rem:
        print(f"# trimming {rem} blocks so the grouped segment is a "
              f"multiple of group_k={group_k}", file=sys.stderr)
        n_blocks -= rem

    warmup = 2 * lookahead   # one warm batch per jit signature (per-block
                             # + grouped) precedes the timed segments

    print(f"# devices: {jax.devices()}", file=sys.stderr)

    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n = 50000 * (n_blocks + warmup)

    print(f"# synthesizing {n / 2.5e6:.1f}s of 8-PRN capture...",
          file=sys.stderr)
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    del iq
    from navlab_dpe_sdr_tpu.io.synth import release_workspace
    release_workspace()     # ~8 GB of one-shot synthesis buffers

    from navlab_dpe_sdr_tpu.models.dpe import DPEConfig
    rf = SampleFile(samples=samples, fs=2.5e6)
    grid = spread_grid()

    def fresh_rx():
        import copy
        # alpha smoother: ~3x lower fix scatter than the reference's
        # passthrough at identical throughput
        return DPEReceiver(SampleFile(samples=samples, fs=2.5e6),
                           copy.deepcopy(hand), grid=grid,
                           eph=copy.deepcopy(arr),
                           config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3))

    rx = fresh_rx()

    # device-resident capture: staged once, so the timed segments measure
    # the receiver and not the host->device copy of the samples
    import jax.numpy as jnp
    all_blocks = samples.view(np.int16).reshape(-1, rx.S, 2)
    raw_dev = jnp.asarray(all_blocks)
    jax.block_until_ready(raw_dev)

    # warm both jit signatures (per-block + grouped) before the clock
    rx.run_batched(lookahead, lookahead=lookahead, raw_blocks_dev=raw_dev,
                   start_block=0)
    rx.run_batched(lookahead, lookahead=lookahead, raw_blocks_dev=raw_dev,
                   start_block=lookahead, group_k=group_k)

    def timed_pass():
        """One full two-segment pass with a fresh receiver; returns
        (rtf_full, rtf_short, errs, n_short_fixes)."""
        r = fresh_rx()
        # untimed state advance over the warmup blocks: the handoff
        # describes capture sample 0, the timed segment starts at block
        # `warmup` — processing those blocks first brings the receiver's
        # clock/state to the segment start (a fresh receiver jumping in
        # 2 s late fixes ~400 m off from satellite motion alone)
        r.run_batched(warmup, lookahead=lookahead, raw_blocks_dev=raw_dev,
                      start_block=0, pipeline=True, pipeline_depth=depth)
        n_warm = len(r.fixes)
        t0 = time.perf_counter()
        r.run_batched(n_short, lookahead=lookahead, raw_blocks_dev=raw_dev,
                      start_block=warmup, pipeline=True, pipeline_depth=depth)
        w_short = time.perf_counter() - t0
        n_sf = len(r.fixes) - n_warm
        t1 = time.perf_counter()
        if n_blocks > n_short:
            r.run_batched(n_blocks - n_short, lookahead=lookahead,
                          raw_blocks_dev=raw_dev,
                          start_block=warmup + n_short,
                          pipeline=True, group_k=group_k,
                          pipeline_depth=depth)
        w = w_short + (time.perf_counter() - t1)
        e = [float(np.linalg.norm(f.x_ecef[0:3] - hand.x_ecef[0:3]))
             for f in r.fixes[n_warm:]]
        return n_blocks * 0.02 / w, n_short * 0.02 / w_short, e, n_sf

    repeats = max(1, int(os.environ.get("NAVLAB_BENCH_REPEATS", "3")))
    passes = [timed_pass() for _ in range(repeats)]
    rtfs = sorted(p[0] for p in passes)
    rtfs_short = sorted(p[1] for p in passes)
    rtf = float(np.median(rtfs))
    rtf_short = float(np.median(rtfs_short))
    _, _, errs, n_short_fixes = passes[0]    # fixes identical across passes
    errs_grouped = errs[n_short_fixes:]
    signal_s = n_blocks * 0.02
    wall = signal_s / rtf
    n_scored = n_short + (n_blocks - n_short) / group_k
    gridpts_s = n_scored * (grid.n_pos + grid.n_vel) * len(hand.prn_list) / wall

    print(f"# {n_blocks} blocks ({signal_s:.0f}s signal): "
          f"rtf median {rtf:.2f}x of {repeats} passes "
          f"[{rtfs[0]:.2f}, {rtfs[-1]:.2f}]; "
          f"median fix error {np.median(errs):.1f} m "
          f"(p95 {np.percentile(errs, 95):.1f}); "
          f"grouped-K{group_k} segment median "
          f"{np.median(errs_grouped) if errs_grouped else float('nan'):.1f} m; "
          f"first-{n_short}-block rtf {rtf_short:.2f}x "
          f"[{rtfs_short[0]:.2f}, {rtfs_short[-1]:.2f}] (per-block fixes); "
          f"grid-point-channel evals/s {gridpts_s:.3e}", file=sys.stderr)

    # scalar-tracking real-time factor on the same capture (8 channels,
    # 1 ms closed-loop DLL/PLL scan on the device): varying input chunks
    # + a value fetch per chunk; per-chunk rtf list -> median + spread.
    scalar_rtf = None
    scalar_rtfs = []
    ms_blocks = samples.view(np.int16).reshape(-1, 2500, 2)
    chunk = 2000
    n_chunks = min(ms_blocks.shape[0] // chunk, 5)
    if n_chunks >= 2:
        from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table
        from navlab_dpe_sdr_tpu.ops import tracking as trk
        tab = jnp.asarray(ca_table(hand.prn_list).astype(np.float32))
        st = trk.init_state(rc=hand.rc, ri=hand.ri, fc=hand.fc, fi=hand.fi)
        # int16 uploads (track_chunk casts on-device)
        chunks = [jnp.asarray(ms_blocks[i * chunk:(i + 1) * chunk])
                  for i in range(n_chunks)]
        st, log = trk.track_chunk(st, chunks[0], tab, rf.fs, rf.fcaid)
        float(jnp.sum(log.iP))                      # compile + warm
        for ch in chunks[1:]:
            t0 = time.perf_counter()
            st, log = trk.track_chunk(st, ch, tab, rf.fs, rf.fcaid)
            float(jnp.sum(log.iP))
            scalar_rtfs.append(chunk * 1e-3 / (time.perf_counter() - t0))
        scalar_rtfs.sort()
        scalar_rtf = float(np.median(scalar_rtfs))
        print(f"# scalar tracking: median {scalar_rtf:.1f}x of "
              f"{len(scalar_rtfs)} chunks [{scalar_rtfs[0]:.1f}, "
              f"{scalar_rtfs[-1]:.1f}] ({len(hand.prn_list)} channels)",
              file=sys.stderr)

    # cold-start time-to-first-fix (see module docstring). Skippable for
    # quick runs: NAVLAB_BENCH_SKIP_TTFF=1.
    ttff = None
    if samples.shape[0] < int(36.0 * 2.5e6):
        ttff = {"skipped": "capture shorter than the ~31 s LNAV "
                           "subframe-1-3 wait; run the full-length bench"}
    elif not os.environ.get("NAVLAB_BENCH_SKIP_TTFF"):
        try:
            ttff = _ttff(samples, hand, grid)
        except Exception as e:      # ttff must never kill the artifact
            ttff = {"error": f"{type(e).__name__}: {e}"[:300]}
        print(f"# ttff: {ttff}", file=sys.stderr)

    # on-device oracle parity runback (SURVEY §4: golden-model
    # cross-validation is the reference's test strategy; the CI
    # equivalence tests run on the CPU): factorized windowed correlator
    # vs its direct form on one real capture block. Set
    # NAVLAB_BENCH_SKIP_PARITY=1 to skip.
    parity = None
    if not os.environ.get("NAVLAB_BENCH_SKIP_PARITY"):
        try:
            parity = _parity_block(samples, hand, arr, grid)
        except Exception as e:   # parity must never kill the bench artifact
            parity = {"error": f"{type(e).__name__}: {e}"[:300]}
        print(f"# parity: {parity}", file=sys.stderr)

    print(json.dumps({
        "metric": "dpe_real_time_factor",
        "value": round(rtf, 2),
        "unit": "x_realtime_2.5MHz_8prn_25^4grid",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": round(rtf / 1.0, 2),
        "protocol": {"passes": repeats, "stat": "median",
                     "warmup": "one warm batch per jit signature"},
        "value_minmax": [round(rtfs[0], 2), round(rtfs[-1], 2)],
        "signal_seconds": signal_s,
        "fix_median_m": round(float(np.median(errs)), 2),
        "fix_p95_m": round(float(np.percentile(errs, 95)), 2),
        "rtf_first_200": round(rtf_short, 2),
        "rtf_first_200_minmax": [round(rtfs_short[0], 2),
                                 round(rtfs_short[-1], 2)],
        "coherent_group_k": group_k,
        "pipeline_depth": depth,
        "grouped_fix_rate_hz": round(1.0 / (group_k * 0.02), 1),
        "fix_median_m_grouped": (None if not errs_grouped else
                                 round(float(np.median(errs_grouped)), 2)),
        "scalar_track_rtf": (None if scalar_rtf is None
                             else round(scalar_rtf, 2)),
        "scalar_track_rtf_minmax": (None if not scalar_rtfs else
                                    [round(scalar_rtfs[0], 2),
                                     round(scalar_rtfs[-1], 2)]),
        "ttff": ttff,
        "parity": parity,
    }))


def _ttff(samples, hand, grid):
    """Cold-start time-to-first-fix on the synthesized capture.

    The reference's product sequence: acquisition (best-of-two 10 ms
    blocks, 8 PRN), closed-loop scalar tracking, LNAV ephemeris decode
    (needs subframes 1-3 => >= ~30 s of signal), handoff, first DPE fix
    (1_Data_reduct_scalar.py:35-108, 3_Data_reduct_dp.py:76-195). Run
    twice: pass 1 warms every jit signature (compilation is a cached
    one-time deployment cost, excluded from the product number), pass 2
    is the timed cold-START (cold receiver STATE) run.
    Returns wall seconds, signal seconds consumed, and the first-fix
    error — in offline replay wall << signal shows the receiver clears
    the pipeline far faster than the eph wait that dominates real TTFF.
    """
    import copy
    import time

    from navlab_dpe_sdr_tpu.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu.models.dpe import DPEConfig, DPEReceiver
    from navlab_dpe_sdr_tpu.models.scalar import ScalarReceiver

    prns = list(hand.prn_list)

    def pipeline():
        rf = SampleFile(samples=samples, fs=2.5e6)
        rx = ScalarReceiver(rf, prns)
        rx.acquire(verbose=False)
        # track to the first point ephemerides CAN be complete, then in
        # 2 s steps until EVERY channel decodes (save_handoff/eph_array
        # export all channels, so a partial decode cannot hand off; the
        # subframe phase differs per PRN, so the tail takes 0-6 s more)
        rx.track(30_000)
        signal_ms = 30_000
        good = rx.decode_ephemerides(verbose=False)
        while len(good) < len(prns) and signal_ms < 44_000:
            rx.track(2_000)
            signal_ms += 2_000
            good = rx.decode_ephemerides(verbose=False)
        if len(good) < len(prns):
            raise RuntimeError(f"only {len(good)}/{len(prns)} "
                               f"ephemerides decoded")
        h = rx.save_handoff("")
        drx = DPEReceiver(SampleFile(samples=samples, fs=2.5e6), h,
                          grid=grid, eph=rx.eph_array(), config=DPEConfig())
        fix = drx.run(1)[0]
        signal_s = h.bytes_read / 4 / 2.5e6 + 0.02
        return signal_s, float(np.linalg.norm(
            np.asarray(fix.x_ecef[0:3]) - hand.x_ecef[0:3])), len(good)

    pipeline()                                   # warm all signatures
    t0 = time.perf_counter()
    signal_s, fix_m, n_eph = pipeline()
    wall = time.perf_counter() - t0
    return {"ttff_s": round(wall, 2), "signal_s": round(signal_s, 2),
            "first_fix_m": round(fix_m, 2), "eph_decoded": n_eph}


def _parity_block(samples, hand, arr, grid):
    """Windowed correlator vs its direct form on the active device, on one
    real capture block with real channel geometry."""
    import jax

    from navlab_dpe_sdr_tpu import parity

    args, kw, _ = parity.correlator_inputs(samples, hand, arr, grid)
    return {"backend": jax.default_backend(),
            **parity.correlator_parity(args, kw, with_cpu=False)}


if __name__ == "__main__":
    main()
