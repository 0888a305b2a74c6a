"""End-to-end smoke run of the receiver on one NVIDIA GPU.

    python chip_smoke.py          # one card: the whole main path
    python chip_smoke.py --four   # only the 4-card mesh path vs one card

One card, at the deployment users run (2.5 MHz int16 I/Q, 8 PRNs, 20 ms
blocks, the reference's 25^4 + 25^4 spread grid), on a synthetic capture
made from a fixed seed:

1. device: pins the GPU (no CPU fallback) and reports the card;
2. cold start: acquisition, closed-loop scalar tracking to a full LNAV
   decode, least-squares fix, handoff (ScalarReceiver, as `cli track`);
3. DPE from that handoff: per-block fixes (DPEReceiver.run) and coherently
   grouped K=5 batches (DPEReceiver.run_batched), as `cli dpe`;
4. parity on the card against plain references (navlab_dpe_sdr_tpu.parity);
5. peak device memory.

Each phase prints its wall time (compilation included) and its checks. Any
failed check or error exits nonzero before the last line. The last line of
stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np

FS = 2.5e6
SEED = 7
CAPTURE_S = 50.0        # cold start decodes by ~31-44 s; DPE needs 10 s more
DPE_BLOCKS = 100        # per-block fixes
GROUPED_BLOCKS = 500    # grouped K=5 run
GROUP_K = 5
TRACK_PARITY_MS = 2000  # one product tracking chunk
SCALAR_FIX_M = 10.0
DPE_MEDIAN_M = 15.0
MESH_BLOCKS = 48        # one product-sized batch, divisible by group_k=4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str):
    print(f"  check {'ok  ' if cond else 'FAIL'} {what}")
    if not cond:
        raise SmokeFailure(what)


class Phase:
    """Prints a phase's wall time, compilation included."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"phase {self.name} ...", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        state = "failed" if exc[0] else "done"
        print(f"phase {self.name} {state}: {dt:.3f} s wall "
              f"(compilation included)", flush=True)
        return False


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {"platform": d.platform,
                                              "kind": d.device_kind,
                                              "count": len(devices)}})


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def synth_capture(seconds: float):
    """(samples [n] int16 I/Q, truth handoff, ephemerides) of the bench
    scenario, generated in 2 s pieces."""
    from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16
    from navlab_dpe_sdr_tpu.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu.io.synth import release_workspace

    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0, seed=SEED)
    n = int(round(seconds * FS))
    samples = np.empty(n, DTYPE_IQ16)
    step = int(2 * FS)
    for s in range(0, n, step):
        iq = sim.generate(min(step, n - s), start_sample=s)
        samples["i"][s:s + iq.shape[0]] = np.clip(np.round(iq.real),
                                                  -32768, 32767)
        samples["q"][s:s + iq.shape[0]] = np.clip(np.round(iq.imag),
                                                  -32768, 32767)
    release_workspace()
    return samples, hand, arr


def cold_start(samples, truth):
    """Acquire -> track to LNAV subframes 1-3 -> decode -> PVT -> handoff,
    the `bench.py` TTFF sequence. Returns (receiver, handoff)."""
    from navlab_dpe_sdr_tpu.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu.libgnss import dataparser
    from navlab_dpe_sdr_tpu.models.scalar import ScalarReceiver

    prns = list(truth.prn_list)
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), prns)
    found = [r.prn for r in rx.acquire(verbose=False) if r.found]
    print(f"  acquired {len(found)}/{len(prns)}: {found}")
    check(len(found) == len(prns), "all PRNs acquired")
    signal_ms = 30_000
    rx.track(signal_ms)
    good = rx.decode_ephemerides(verbose=False)
    while len(good) < len(prns) and signal_ms < 44_000:
        rx.track(2_000)
        signal_ms += 2_000
        good = rx.decode_ephemerides(verbose=False)
    parity = [dataparser.parse_ephemerides(rx.channels[p].cp_sign, 0.0,
                                           p)[1] for p in good]
    print(f"  tracked {signal_ms / 1e3:.0f} s; ephemerides "
          f"{len(good)}/{len(prns)}, word parity {parity} of 50")
    check(len(good) == len(prns), "all ephemerides decoded")
    check(all(p == 50 for p in parity), "full LNAV word parity")
    _, _, x_ecef, _, _ = rx.nav_solution()
    err = float(np.linalg.norm(np.asarray(x_ecef)[:3] - truth.x_ecef[:3]))
    print(f"  scalar fix error {err:.3f} m")
    check(err < SCALAR_FIX_M, f"scalar fix within {SCALAR_FIX_M} m")
    return rx, rx.save_handoff("")


def dpe(samples, handoff, eph, truth, grid, n_blocks=DPE_BLOCKS,
        n_grouped=GROUPED_BLOCKS, group_k=GROUP_K):
    """Per-block and grouped-K DPE from one handoff, default config."""
    from navlab_dpe_sdr_tpu.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu.models.dpe import DPEConfig, DPEReceiver

    def receiver():
        return DPEReceiver(SampleFile(samples=samples, fs=FS),
                           copy.deepcopy(handoff), grid=grid,
                           eph=copy.deepcopy(eph), config=DPEConfig())

    for label, run in (("per-block", lambda r: r.run(n_blocks)),
                       (f"grouped K={group_k}",
                        lambda r: r.run_batched(n_grouped, group_k=group_k))):
        t0 = time.perf_counter()
        fixes = run(receiver())
        wall = time.perf_counter() - t0
        errs = [float(np.linalg.norm(f.x_ecef[:3] - truth.x_ecef[:3]))
                for f in fixes]
        med = float(np.median(errs))
        print(f"  {label}: {len(fixes)} fixes in {wall:.3f} s "
              f"(compilation included); fix error median {med:.3f} m, "
              f"p95 {float(np.percentile(errs, 95)):.3f} m")
        check(med < DPE_MEDIAN_M, f"{label} median fix error < "
                                  f"{DPE_MEDIAN_M} m")


def parity(samples, hand, arr, grid, track_state, track_raw, code_table,
           fcaid):
    """Product kernels on the default device vs plain references."""
    from navlab_dpe_sdr_tpu import parity as par

    tol = par.TOL_REL
    print("  matmul precision: JAX default (the program sets none; "
          "float32 dots may run as TF32)")
    args, kw, fpk = par.correlator_inputs(samples, hand, arr, grid)
    rep = par.correlator_parity(args, kw)
    rep.update(par.manifold_scorer_parity(args, kw, fpk, grid))
    rep.update(par.engine_parity(samples, hand, arr, grid))
    rep.update(par.tracking_parity(track_state, track_raw, code_table, FS,
                                   fcaid))
    print(f"  parity: {json.dumps(rep)}")
    for k in ("corr_code_max_rel", "corr_carr_max_rel", "cpu_code_max_rel",
              "cpu_carr_max_rel", "pos_score_max_rel", "vel_score_max_rel",
              "track_power_median_rel"):
        check(rep[k] <= tol, f"{k} {rep[k]:.3e} <= {tol}")
    for k in ("corr_flip_equal", "corr_argmax_equal", "cpu_flip_equal",
              "cpu_argmax_equal", "pos_score_argmax_equal",
              "vel_score_argmax_equal", "track_lock_equal"):
        check(rep[k], k)
    for k, lim in (("track_power_max_rel", par.TRACK_MAX_REL),
                   ("track_fi_max_hz", par.TRACK_FI_HZ),
                   ("track_rc_max_chips", par.TRACK_RC_CHIPS)):
        check(rep[k] <= lim, f"{k} {rep[k]:.3e} <= {lim}")
    check(rep["engine_argmax_near_max"] >= par.ENGINE_NEAR_MAX,
          f"engine_argmax_near_max {rep['engine_argmax_near_max']:.6f} "
          f">= {par.ENGINE_NEAR_MAX}")
    check(rep["engine_surface_corr"] >= par.ENGINE_MIN_CORR,
          f"engine_surface_corr {rep['engine_surface_corr']:.6f} >= "
          f"{par.ENGINE_MIN_CORR}")
    return rep


def four(samples, hand, arr, grid, devices, n_blocks=MESH_BLOCKS):
    """`cli dpe --mesh grid=4`'s dpe_batch_blocks vs the same call on one
    device, per-block and grouped K=4."""
    from navlab_dpe_sdr_tpu import parity as par
    from navlab_dpe_sdr_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_grid=len(devices), devices=devices)
    rep = par.mesh_parity(samples, hand, arr, grid, mesh, n_blocks)
    print(f"  mesh parity: {json.dumps(rep)}")
    for gk in (1, 4):
        check(rep[f"k{gk}_argmax_equal"], f"group_k={gk} argmax rows equal")
        check(rep[f"k{gk}_flip_equal"], f"group_k={gk} flips equal")
        check(rep[f"k{gk}_score_max_rel"] <= par.TOL_REL,
              f"group_k={gk} peak scores {rep[f'k{gk}_score_max_rel']:.3e} "
              f"<= {par.TOL_REL}")
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device mesh path and its "
                         "one-device comparison")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    with Phase("device"):
        card = card_name_and_power_limit()      # before JAX opens the card
        import jax

        from navlab_dpe_sdr_tpu.device import select_device, use_compile_cache
        select_device("gpu")
        cache = use_compile_cache()
        devices = jax.devices()
        print(f"  card: {card}")
        print(f"  jax {jax.__version__}: {len(devices)} x "
              f"{devices[0].device_kind} ({devices[0].platform}); "
              f"compile cache {cache}")
        check(devices[0].platform == "gpu", "first device is a GPU")
        if args.four:
            check(len(devices) >= 4, "four GPUs")
            devices = devices[:4]
        else:
            devices = devices[:1]

    from navlab_dpe_sdr_tpu.models.grid import spread_grid
    grid = spread_grid()

    if args.four:
        with Phase("synthesize capture"):
            samples, truth, arr = synth_capture(1.2)
        with Phase("mesh vs one device"):
            four(samples, truth, arr, grid, devices)
    else:
        with Phase("synthesize capture"):
            samples, truth, arr = synth_capture(CAPTURE_S)
        with Phase("cold start"):
            rx, handoff = cold_start(samples, truth)
        with Phase("dpe"):
            dpe(samples, handoff, rx.eph_array(), truth, grid)
        with Phase("parity"):
            pos = rx.rawfile.sample_pos
            raw = (samples[pos:pos + TRACK_PARITY_MS * 2500]
                   .view(np.int16).reshape(TRACK_PARITY_MS, 2500, 2))
            parity(samples, truth, arr, grid, rx.state, raw,
                   np.asarray(rx.code_table), rx.rawfile.fcaid)

    with Phase("memory"):
        for d in devices:
            peak = d.memory_stats()["peak_bytes_in_use"]
            print(f"  {d}: peak_bytes_in_use {peak} "
                  f"({peak / 2 ** 30:.3f} GiB)")
    print(f"total wall {time.perf_counter() - t_start:.3f} s")
    print(f"card (name, power limit): {card}")
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
