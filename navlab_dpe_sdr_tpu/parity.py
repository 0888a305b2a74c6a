"""Parity of the device hot path against plain references.

Each check runs the product kernel on the default device and compares it
with an independent form of the same math: the direct (unfactorized)
windowed correlator, the full-FFT engine (ops/dpe.py, the reference's own
formulation), a float64 NumPy 3-tap scorer, and the same jitted call on the
CPU backend. chip_smoke.py runs them on the GPU at product widths; the
tests run them on the CPU at small ones.

Tolerances (TOL_REL) are relative to the reference's peak. Float32
matmuls run at JAX's default precision (the program sets none), which a
GPU may execute as TF32 (10-bit mantissa, ~5e-4 relative rounding), so
2e-3 is the TF32 class; argmax, nav-bit flip and lock decisions must be
equal.
"""

from __future__ import annotations

import copy
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from .io.rawfile import SampleFile
from .models.dpe import DPEConfig, DPEReceiver
from .ops import dpe_real as dr
from .ops import tracking as trk

TOL_REL = 2e-3
# A scorer point whose float64 tap index lies this close to a rounding
# boundary may pick the other 3-tap triplet in float32/TF32 (a different,
# equally valid interpolant): such points are left out of the comparison.
TAP_BOUNDARY_MARGIN = 0.01
# Engine parity: the real and FFT engines interpolate differently, so
# their noisy position surfaces can peak at neighbouring grid points.
# Each engine's argmax must score within this fraction of the other's max.
ENGINE_NEAR_MAX = 0.999
ENGINE_MIN_CORR = 0.99
# Tracking (closed loop, GPU vs CPU; see tracking_parity): the largest
# one-window prompt-power difference, and the loop-state agreement.
TRACK_MAX_REL = 0.05
TRACK_FI_HZ = 1.0
TRACK_RC_CHIPS = 0.01


def max_rel(a, b) -> float:
    """max |a - b| over max |b| (b is the reference)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _on_cpu(fn, *args):
    """fn(*args) compiled for and run on the CPU backend."""
    cpu = jax.devices("cpu")[0]
    host = jax.tree.map(np.asarray, args)
    with jax.default_device(cpu):
        return jax.tree.map(np.asarray, fn(*host))


def block_receiver(samples, hand, arr, grid, config=None) -> DPEReceiver:
    return DPEReceiver(SampleFile(samples=samples, fs=2.5e6),
                       copy.deepcopy(hand), grid=grid,
                       eph=copy.deepcopy(arr), config=config or DPEConfig())


def correlator_inputs(samples, hand, arr, grid):
    """(args, kw, fpk) for windowed_correlate on the first product block
    after the handoff, with the receiver's own prediction for it."""
    rx = block_receiver(samples, hand, arr, grid)
    fpk, ipk, *_ = rx._prepare_block()
    raw = samples[hand.bytes_read // 4:][:rx.S]
    args = (raw["i"].astype(np.float32), raw["q"].astype(np.float32),
            np.asarray(rx._chips_f32), np.asarray(rx._base0),
            fpk[0], ipk[0], fpk[1], fpk[2], np.asarray(rx._time_idc),
            ipk[1], ipk[2])
    kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
              n_periods=rx.S // rx.period, code_win=rx.code_win,
              carr_win=rx.carr_win)
    return args, kw, fpk


def correlator_parity(args, kw, with_cpu: bool = True) -> dict:
    """windowed_correlate vs its direct form (same device) and vs itself
    on the CPU backend."""
    fast = dr.windowed_correlate(*args, **kw)
    direct = dr._windowed_correlate_direct(*args, **kw)
    out = {
        "corr_code_max_rel": max_rel(fast.code_mag, direct.code_mag),
        "corr_carr_max_rel": max_rel(fast.carr_mag, direct.carr_mag),
        "corr_flip_equal": bool(np.array_equal(np.asarray(fast.flip_used),
                                               np.asarray(direct.flip_used))),
        "corr_argmax_equal": bool(
            np.array_equal(np.argmax(np.asarray(fast.code_mag), 1),
                           np.argmax(np.asarray(direct.code_mag), 1))
            and np.array_equal(np.argmax(np.asarray(fast.carr_mag), 1),
                               np.argmax(np.asarray(direct.carr_mag), 1))),
    }
    if with_cpu:
        cpu = _on_cpu(functools.partial(dr.windowed_correlate, **kw), *args)
        out.update({
            "cpu_code_max_rel": max_rel(fast.code_mag, cpu.code_mag),
            "cpu_carr_max_rel": max_rel(fast.carr_mag, cpu.carr_mag),
            "cpu_flip_equal": bool(np.array_equal(
                np.asarray(fast.flip_used), cpu.flip_used)),
            "cpu_argmax_equal": bool(
                np.array_equal(np.argmax(np.asarray(fast.code_mag), 1),
                               np.argmax(cpu.code_mag, 1))
                and np.array_equal(np.argmax(np.asarray(fast.carr_mag), 1),
                                   np.argmax(cpu.carr_mag, 1))),
        })
    return out


def score_reference(win, los, centers, coefs, r0, o3, o1, l_power: int = 1):
    """Float64 NumPy 3-tap quadratic scorer: (scores [N, G], keep [G]).

    win [N, C, W]; los [N, C, 3]; centers/coefs [N, C]; r0 [N, C] or None
    (velocity manifold); o3 [G, 3]; o1 [G]. keep marks the grid points
    whose tap choice is unambiguous (TAP_BOUNDARY_MARGIN) in every block
    and channel."""
    win = np.asarray(win, np.float64)
    los = np.asarray(los, np.float64)
    o3 = np.asarray(o3, np.float64)
    o1 = np.asarray(o1, np.float64)
    centers = np.asarray(centers, np.float64)[..., None]
    coefs = np.asarray(coefs, np.float64)[..., None]
    w = win.shape[2]
    u = np.einsum("gj,ncj->ncg", o3, los)
    rng = -u
    if r0 is not None:
        r0 = np.asarray(r0, np.float64)[..., None]
        rng = rng + (np.sum(o3 * o3, axis=1) - u * u) / (2.0 * r0)
    idx = centers + coefs * (rng + o1)                      # [N, C, G]
    k0 = np.clip(np.round(idx), 1, w - 2).astype(np.int64)
    d = idx - k0

    def tap(k):
        return np.take_along_axis(win, k, axis=2)

    vals = (0.5 * (d * d - d) * tap(k0 - 1) + (1.0 - d * d) * tap(k0)
            + 0.5 * (d * d + d) * tap(k0 + 1))
    frac = idx - np.floor(idx)
    interior = (idx > 1.5 + TAP_BOUNDARY_MARGIN) & (
        idx < w - 2.5 - TAP_BOUNDARY_MARGIN)
    ambiguous = interior & (np.abs(frac - 0.5) < TAP_BOUNDARY_MARGIN)
    keep = ~np.any(ambiguous, axis=(0, 1))
    return np.sum(vals ** l_power, axis=1), keep


@functools.partial(jax.jit, static_argnames=("l_power",))
def _score_chunk_jit(win, los, centers, coefs, r0, o3, o1, l_power=1):
    return dr._score_chunk(win, los, centers, coefs, r0, o3, o1,
                           "quadratic", l_power)


def score_chunks(win, los, centers, coefs, r0, o3, o1, l_power: int = 1,
                 chunk: int = dr.SCORE_CHUNK) -> np.ndarray:
    """The product scorer `_score_chunk` over the whole grid in product
    chunks (the last one zero-padded): [N, G]."""
    g = o3.shape[0]
    pad = (-g) % chunk
    o3p = np.pad(np.asarray(o3, np.float32), ((0, pad), (0, 0)))
    o1p = np.pad(np.asarray(o1, np.float32), ((0, pad),))
    dev = [None if x is None else jnp.asarray(x)
           for x in (win, los, centers, coefs, r0)]
    parts = [_score_chunk_jit(*dev, o3p[s:s + chunk], o1p[s:s + chunk],
                              l_power)
             for s in range(0, g + pad, chunk)]
    return np.concatenate([np.asarray(p) for p in parts], axis=1)[:, :g]


def scorer_parity(win, los, centers, coefs, r0, o3, o1,
                  l_power: int = 1, chunk: int = dr.SCORE_CHUNK) -> dict:
    got = score_chunks(win, los, centers, coefs, r0, o3, o1, l_power, chunk)
    ref, keep = score_reference(win, los, centers, coefs, r0, o3, o1,
                                l_power)
    return {"score_max_rel": max_rel(got[:, keep], ref[:, keep]),
            "score_argmax_equal": bool(np.array_equal(
                np.argmax(got[:, keep], 1), np.argmax(ref[:, keep], 1))),
            "score_points_compared": int(keep.sum())}


def manifold_scorer_parity(args, kw, fpk, grid) -> dict:
    """scorer_parity of both manifolds on one block's correlation windows,
    every channel, the whole grid."""
    out = dr.windowed_correlate(*args, **kw)
    los = fpk[3:6].T[None]
    pos = scorer_parity(np.asarray(out.code_mag)[None], los, fpk[7][None],
                        fpk[8][None], fpk[6][None], grid.d_enu, grid.dt_m)
    vel = scorer_parity(np.asarray(out.carr_mag)[None], los, fpk[9][None],
                        fpk[10][None], None, grid.dv_enu, grid.dtdot)
    return {**{f"pos_{k}": v for k, v in pos.items()},
            **{f"vel_{k}": v for k, v in vel.items()}}


def engine_parity(samples, hand, arr, grid, n_blocks: int = 2) -> dict:
    """Per-block score surfaces of the real engine vs the FFT engine over
    the same blocks, through the receivers' own score dumps."""
    surf = {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("real", "fft"):
            d = os.path.join(tmp, engine)
            os.makedirs(d)
            rx = block_receiver(samples, hand, arr, grid,
                                DPEConfig(engine=engine, dump_scores_to=d))
            rx.run(n_blocks)
            surf[engine] = [dict(np.load(f"{d}/scores_{k:06d}.npz"))
                            for k in range(1, n_blocks + 1)]
    near, corr, vel_equal = 1.0, 1.0, True
    for a, b in zip(surf["real"], surf["fft"]):
        for m in ("pos", "vel"):
            x, y = a[m].astype(np.float64), b[m].astype(np.float64)
            near = min(near, y[x.argmax()] / y.max(), x[y.argmax()] / x.max())
            corr = min(corr, float(np.corrcoef(x, y)[0, 1]))
        vel_equal &= int(a["vel"].argmax()) == int(b["vel"].argmax())
    return {"engine_argmax_near_max": float(near),
            "engine_surface_corr": corr,
            "engine_vel_argmax_equal": bool(vel_equal)}


def tracking_parity(state, raw_i16, code_table, fs, fcaid) -> dict:
    """track_chunk on the default device vs the same call on the CPU
    backend, from one state over the same samples.

    The closed loop cannot agree sample for sample: a chip index within an
    ulp of an integer floors differently under another backend's float32
    rounding (one replica sample flips), and the Costas loop may settle a
    window on either side of its pi ambiguity. So the comparison is on
    what tracking delivers: prompt power |P| (pi-invariant) with a median
    within TOL_REL and no window off by more than TRACK_MAX_REL, the loop
    states (carrier Doppler fi, code phase rc), and the lock flags."""
    fn = functools.partial(trk.track_chunk, fs=fs, fcaid=fcaid)
    _, log_d = fn(state, jnp.asarray(raw_i16), jnp.asarray(code_table))
    _, log_c = _on_cpu(fn, state, raw_i16, code_table)

    def power(log):
        return np.hypot(np.asarray(log.iP, np.float64),
                        np.asarray(log.qP, np.float64))

    p_d, p_c = power(log_d), power(log_c)
    rel = np.abs(p_d - p_c) / p_c.max()
    drc = np.abs(np.asarray(log_d.rc, np.float64) - log_c.rc)
    drc = np.minimum(drc, 1023.0 - drc)                    # code phase wraps
    return {
        "track_steps": int(raw_i16.shape[0]),
        "track_power_median_rel": float(np.median(rel)),
        "track_power_max_rel": float(rel.max()),
        "track_fi_max_hz": float(np.max(np.abs(
            np.asarray(log_d.fi, np.float64) - log_c.fi))),
        "track_rc_max_chips": float(drc.max()),
        "track_lock_equal": bool(np.array_equal(np.asarray(log_d.lock),
                                                log_c.lock)),
        "track_locked_final": int(np.asarray(log_d.lock)[-1].sum()),
    }


def mesh_parity(samples, hand, arr, grid, mesh, n_blocks: int,
                group_ks=(1, 4)) -> dict:
    """dpe_batch_blocks over `mesh` (the `cli dpe --mesh` path) vs the same
    call on one device: per group_k, argmax rows equal, peak scores and
    flips within tolerance."""
    from .parallel.mesh import shard_grid

    rx = block_receiver(samples, hand, arr, grid)
    preps = rx._prepare_batch(n_blocks)
    pk = jnp.asarray(dr.pack_params(np.stack([p[0] for p in preps]),
                                    np.stack([p[1] for p in preps]), 0))
    raw = jnp.asarray(samples[hand.bytes_read // 4:][:n_blocks * rx.S]
                      .view(np.int16).reshape(n_blocks, rx.S, 2))
    g4 = (rx._d_enu, rx._dt_m, rx._dv_enu, rx._dtdot)
    out = {"mesh": dict(mesh.shape), "mesh_devices": int(mesh.devices.size)}
    for gk in group_ks:
        kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
                  n_periods=rx.S // rx.period, n_blocks=n_blocks,
                  return_windows=False, code_win=rx.code_win,
                  carr_win=rx.carr_win, group_k=gk)
        one = np.asarray(dr.dpe_batch_blocks(
            raw, pk, rx._chips_f32, rx._base0, rx._time_idc, *g4, **kw))
        many = np.asarray(dr.dpe_batch_blocks(
            raw, pk, rx._chips_f32, rx._base0, rx._time_idc,
            *shard_grid(mesh, g4), mesh=mesh, **kw))
        pa1, va1 = dr.unpack_row_indices(one)
        pa4, va4 = dr.unpack_row_indices(many)
        out[f"k{gk}_rows"] = int(one.shape[0])
        out[f"k{gk}_argmax_equal"] = bool(np.array_equal(pa1, pa4)
                                          and np.array_equal(va1, va4))
        out[f"k{gk}_score_max_rel"] = max(max_rel(many[:, 1], one[:, 1]),
                                          max_rel(many[:, 3], one[:, 3]))
        out[f"k{gk}_flip_equal"] = bool(np.array_equal(many[:, 4:],
                                                       one[:, 4:]))
    return out
