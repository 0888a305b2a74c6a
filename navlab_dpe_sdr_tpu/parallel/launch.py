"""Multi-host launch: jax.distributed + global (chan x grid) mesh.

The reference is single-process/single-GPU (SURVEY §2.3 P7 — no
communication backend exists); this module provides the scale-out the
BASELINE north star asks for: each host runs one process, the position-time
grid shards globally over all devices, per-host sample files replace the
reference's unused TCP socket mode, and the per-block boundary state (a few
hundred bytes of phases/counters) is replicated rather than communicated.

Launch (one command per host):

    python -m navlab_dpe_sdr_tpu.parallel.launch \
        --coordinator host0:9123 --num-processes 4 --process-id $RANK \
        --capture /data/cap_$RANK.dat --handoff hand.csv --blocks 1000
"""

from __future__ import annotations

import argparse

import numpy as np


def init_distributed(coordinator: str, num_processes: int, process_id: int):
    """Join the job (virtual CPU devices: run with JAX_PLATFORMS=cpu)."""
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.devices()


def global_mesh(n_chan: int = 1):
    """Mesh over every device of every participating process."""
    from .mesh import make_mesh
    import jax

    return make_mesh(n_chan=n_chan, devices=jax.devices())


def scaling_bench(mesh, n_iters: int = 3, grid_scale: int = 1,
                  n_blocks: int = 8, n_chan_sig: int = 8):
    """Grid-points/s throughput of the sharded batched DPE path on this
    mesh — the BASELINE scaling-efficiency metric, measured on the product
    hot path (dpe_batch_blocks: correlation + shard_map streaming-argmax
    manifold scoring) with a spread grid replicated `grid_scale` times
    along the grid axis. mesh=None measures the single-device path.

    n_blocks=8: divisible by every mesh size measured (1/2/4/8) so the
    block-sharded correlation stage stays load-balanced (5 blocks over 4
    devices ran 2/1/1/1 and capped correlation efficiency at 0.625)."""
    import os
    import sys
    import time

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    import __graft_entry__ as ge
    from ..models.grid import spread_grid
    from ..ops import dpe_real as dr

    c, s = n_chan_sig, 50000
    args, meta = ge._example_args(c=c, s=s)
    (raw_re, raw_im, chips, base0, rc_mid, idx_next, fi, ri, time_idc,
     pos_start, vel_start, params) = args[:12]

    rng = np.random.default_rng(7)
    raw_all = rng.integers(-2048, 2048, (n_blocks, s, 2)).astype(np.int16)
    fpk = np.zeros((n_blocks, dr.FPK_ROWS, c), np.float32)
    ipk = np.zeros((n_blocks, dr.IPK_ROWS, c), np.int32)
    fpk[:, 0] = np.asarray(rc_mid)
    fpk[:, 1] = np.asarray(fi)
    fpk[:, 2] = np.asarray(ri)
    fpk[:, 3:6] = np.asarray(params.los_enu).T
    fpk[:, 6] = np.asarray(params.r0)
    fpk[:, 7] = np.asarray(params.pos_center)
    fpk[:, 8] = np.asarray(params.pos_coef)
    fpk[:, 9] = np.asarray(params.vel_center)
    fpk[:, 10] = np.asarray(params.vel_coef)
    ipk[:, 0] = np.asarray(idx_next)
    ipk[:, 1] = np.asarray(pos_start)
    ipk[:, 2] = np.asarray(vel_start)

    g = spread_grid()
    d_enu = jnp.asarray(np.tile(g.d_enu, (grid_scale, 1)).astype(np.float32))
    dt_m = jnp.asarray(np.tile(g.dt_m, grid_scale).astype(np.float32))
    dv_enu = jnp.asarray(np.tile(g.dv_enu, (grid_scale, 1)).astype(np.float32))
    dtdot = jnp.asarray(np.tile(g.dtdot, grid_scale).astype(np.float32))

    # grid-adaptive score windows for the scaled grid (the index span
    # grows with grid_scale; fixed windows would clamp outer points)
    from ..ops.dpe import auto_windows
    cw, vw = auto_windows(np.asarray(d_enu), np.asarray(dt_m),
                          np.asarray(dv_enu), np.asarray(dtdot), 2.5e6,
                          meta["carr_fftpts"])
    fpk[:, 7] = cw / 2.0
    fpk[:, 9] = vw / 2.0
    ipk[:, 1] = s // 2 - cw // 2
    ipk[:, 2] = meta["carr_fftpts"] // 2 - vw // 2
    pk = dr.pack_params(fpk, ipk, 0)

    def call():
        return dr.dpe_batch_blocks(
            jnp.asarray(raw_all), jnp.asarray(pk),
            chips, base0, time_idc, d_enu, dt_m, dv_enu, dtdot,
            carr_fftpts=meta["carr_fftpts"], period=meta["period"],
            n_periods=meta["n_periods"], n_blocks=n_blocks,
            return_windows=False, mesh=mesh, code_win=cw, carr_win=vw)

    jax.block_until_ready(call())                       # warm
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = call()
    jax.block_until_ready(out)
    dt_s = (time.perf_counter() - t0) / n_iters / n_blocks
    n_pts = d_enu.shape[0] + dv_enu.shape[0]
    return {"sec_per_block": dt_s, "grid_points_per_s": n_pts / dt_s,
            "devices": 1 if mesh is None else int(mesh.devices.size)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--capture", help="this host's sample file shard")
    p.add_argument("--handoff")
    p.add_argument("--blocks", type=int, default=100)
    p.add_argument("--batched", action="store_true",
                   help="use the batched scan path (run_batched)")
    p.add_argument("--bench-only", action="store_true")
    p.add_argument("--grid", default="spread",
                   choices=["spread", "uniform", "dense"])
    p.add_argument("--grid-n", type=int, help="uniform/dense axis points")
    p.add_argument("--grid-spacing", type=float)
    args = p.parse_args(argv)

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    mesh = global_mesh()

    if args.bench_only or not args.capture:
        stats = scaling_bench(mesh)
        print(f"[proc {args.process_id}] {stats}")
        return

    # full multi-host DPE: every process runs the identical host loop on its
    # own capture shard; the jitted device step is built over the global
    # mesh (DPEConfig.mesh), so grid scoring shards across every device of
    # every process and the fix replicates back
    from ..io.handoff import read_handoff
    from ..io.rawfile import SampleFile
    from ..models.dpe import DPEConfig, DPEReceiver
    from ..models.grid import make_grid

    gkw = {}
    if args.grid_n:
        gkw["n"] = args.grid_n
    if args.grid_spacing:
        gkw["pos_spacing"] = args.grid_spacing
    if args.grid == "spread" and gkw:
        p.error("--grid-n/--grid-spacing need --grid uniform or dense")
    grid = make_grid(args.grid, **gkw) if args.grid != "spread" else None
    hand = read_handoff(args.handoff)
    rf = SampleFile(args.capture, fs=2.5e6)
    rx = DPEReceiver(rf, hand, grid=grid, config=DPEConfig(mesh=mesh))
    if args.batched:
        rx.run_batched(args.blocks)
    else:
        rx.run(args.blocks)
    print(f"[proc {args.process_id}] final fix {rx.fixes[-1].x_ecef[:3]}")


if __name__ == "__main__":
    main()
