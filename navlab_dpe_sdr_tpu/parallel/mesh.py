"""Device-mesh scale-out for the DPE pipeline.

Two sharded axes (SURVEY §2.3):

- 'chan': satellite channels — batch axis of the correlation FFTs.
- 'grid': position/velocity grid points — the primary scaling axis
  (the reference's 25^4-point manifolds, cap 2*75^4 ~ 63M points).

The sharded step is a single jitted computation with sharding constraints;
XLA GSPMD inserts the collectives (all-gather of the tiny per-channel score
windows, sharded grid scoring, global argmax combine). Grid-point state is
never communicated — only the [C, W] windows (a few KB) and the 8-vector
argmax result cross the interconnect between devices (NVLink on GPUs).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import dpe as dpe_ops
from ..ops import dpe_real as dpe_real_ops


def make_mesh(n_grid: int | None = None, n_chan: int = 1,
              devices=None) -> Mesh:
    """Mesh over ('chan', 'grid'). Defaults: all devices on the grid axis."""
    devices = np.array(devices if devices is not None else jax.devices())
    n = devices.size
    if n_grid is None:
        n_grid = n // n_chan
    assert n_chan * n_grid == n, (n_chan, n_grid, n)
    return Mesh(devices.reshape(n_chan, n_grid), ("chan", "grid"))


def shard_grid(mesh: Mesh, grid_arrays):
    """Place (d_enu, dt_m, dv_enu, dtdot) sharded over the grid axis.

    device_put requires even divisibility; when a grid axis doesn't divide
    (e.g. 25^4 = 390625 over 4 devices) the arrays are placed replicated
    instead — the with_sharding_constraint inside the jitted step still
    shards the scoring compute (GSPMD pads internally), only the at-rest
    storage of these small arrays stays replicated."""
    d_enu, dt_m, dv_enu, dtdot = grid_arrays
    nd = int(mesh.shape["grid"])

    def put(x, spec):
        if x.shape[0] % nd:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return (put(d_enu, P("grid", None)), put(dt_m, P("grid")),
            put(dv_enu, P("grid", None)), put(dtdot, P("grid")))


def sharded_dpe_step_real(mesh: Mesh, carr_fftpts: int, period: int,
                          n_periods: int, l_power: int = 1,
                          interp: str = "quadratic",
                          code_win: int | None = None,
                          carr_win: int | None = None):
    """Multi-device fused step for the real windowed engine.

    Channel-batched correlation shards over 'chan'; manifold scoring shards
    over 'grid'; outputs are replicated.
    """
    chan_sh = NamedSharding(mesh, P("chan", None))
    grid_vec = NamedSharding(mesh, P("grid"))
    grid_mat = NamedSharding(mesh, P("grid", None))
    repl_sh = NamedSharding(mesh, P())

    def step(raw_re, raw_im, chips, base0, rc_mid, idx_next, fi, ri,
             time_idc, pos_start, vel_start, params,
             d_enu, dt_m, dv_enu, dtdot):
        chips = jax.lax.with_sharding_constraint(chips, chan_sh)
        d_enu = jax.lax.with_sharding_constraint(d_enu, grid_mat)
        dt_m = jax.lax.with_sharding_constraint(dt_m, grid_vec)
        dv_enu = jax.lax.with_sharding_constraint(dv_enu, grid_mat)
        dtdot = jax.lax.with_sharding_constraint(dtdot, grid_vec)
        out = dpe_real_ops.dpe_device_step_real(
            raw_re, raw_im, chips, base0, rc_mid, idx_next, fi, ri,
            time_idc, pos_start, vel_start, params,
            d_enu, dt_m, dv_enu, dtdot,
            carr_fftpts=carr_fftpts, period=period, n_periods=n_periods,
            l_power=l_power, interp=interp,
            code_win=code_win or dpe_ops.CODE_WIN,
            carr_win=carr_win or dpe_ops.CARR_WIN)
        return jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, repl_sh)
            if x.ndim == 0 else x, out)

    return jax.jit(step)


def sharded_dpe_step(mesh: Mesh, carr_fftpts: int, l_power: int = 1,
                     interp: str = "quadratic",
                     code_win: int | None = None,
                     carr_win: int | None = None):
    """Build the jitted multi-device DPE step for a given mesh (FFT engine).

    Correlation FFTs shard over 'chan'; manifold scoring shards over 'grid';
    outputs (scalars + small vectors) are replicated.
    """
    chan_sh = NamedSharding(mesh, P("chan", None))
    grid_vec = NamedSharding(mesh, P("grid"))
    grid_mat = NamedSharding(mesh, P("grid", None))
    repl_sh = NamedSharding(mesh, P())

    def step(raw, code_fft0, m_int, m_frac, idx_next, fi, ri, time_idc,
             pos_start, vel_start, params, d_enu, dt_m, dv_enu, dtdot):
        code_fft0 = jax.lax.with_sharding_constraint(code_fft0, chan_sh)
        d_enu = jax.lax.with_sharding_constraint(d_enu, grid_mat)
        dt_m = jax.lax.with_sharding_constraint(dt_m, grid_vec)
        dv_enu = jax.lax.with_sharding_constraint(dv_enu, grid_mat)
        dtdot = jax.lax.with_sharding_constraint(dtdot, grid_vec)
        out = dpe_ops.dpe_device_step(
            raw, code_fft0, m_int, m_frac, idx_next, fi, ri, time_idc,
            pos_start, vel_start, params, d_enu, dt_m, dv_enu, dtdot,
            carr_fftpts=carr_fftpts, l_power=l_power, interp=interp,
            code_win=code_win or dpe_ops.CODE_WIN,
            carr_win=carr_win or dpe_ops.CARR_WIN)
        # replicate the tiny results
        return jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, repl_sh)
            if x.ndim == 0 else x, out)

    return jax.jit(step)


def scoring_only_step(mesh: Mesh, l_power: int = 1):
    """Sharded manifold-scoring step (windows replicated, grid sharded) —
    the communication-minimal inner loop used for scaling benchmarks."""
    grid_vec = NamedSharding(mesh, P("grid"))
    grid_mat = NamedSharding(mesh, P("grid", None))
    rep = NamedSharding(mesh, P())

    @functools.partial(jax.jit)
    def step(code_win, carr_win, params, d_enu, dt_m, dv_enu, dtdot):
        code_win = jax.lax.with_sharding_constraint(code_win, rep)
        carr_win = jax.lax.with_sharding_constraint(carr_win, rep)
        d_enu = jax.lax.with_sharding_constraint(d_enu, grid_mat)
        dt_m = jax.lax.with_sharding_constraint(dt_m, grid_vec)
        dv_enu = jax.lax.with_sharding_constraint(dv_enu, grid_mat)
        dtdot = jax.lax.with_sharding_constraint(dtdot, grid_vec)
        return dpe_ops.score_manifolds(code_win, carr_win, params,
                                       d_enu, dt_m, dv_enu, dtdot,
                                       l_power=l_power)

    return step
