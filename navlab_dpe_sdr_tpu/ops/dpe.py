"""DPE device kernels: 20 ms batch correlators + manifold scoring.

Stage 1 — `batch_correlate`: per channel, over one 20 ms block (S samples):
  code-domain circular correlation (dual flip/no-flip replicas for the
  navigation-bit boundary, chosen by |corr[0]|) and the zero-padded carrier
  FFT after code wipeoff. All channels in one batched FFT set.
  Parity: reference correlator.vector_correlate_unfolded
  (pygnss correlator.py:367-465) == CUDARecv BatchCorrScores
  (batchcorrscores.cu:975-1207).

  Gather-free replica generation: instead of a per-sample chip lookup (an
  XLA gather), the replica is a
  circular fractional shift of the per-channel *nominal* code waveform,
  applied in the frequency domain: R_k = N_k * exp(2*pi*i*k*m/S). The shift
  m (samples) = (rc + dfc*T/2) * fs/F_CA is split into integer + fractional
  parts on the host so the phase ramp is computed exactly in f32. This is
  both gather-free and less quantized than the reference's nearest-chip
  replica (batchcorrscores.cu:323-372).

Stage 2 — `score_manifolds`: scores 25^4-style position and velocity grids.
  The reference back-calculates an absolute code phase / Doppler per
  (grid point x channel) in double precision and gathers into the score
  arrays (batchcorrmanifold.cu:1710-1963). Here the host computes each
  channel's float64 *center* index once per block; grid offsets — exactly
  linear in the ENU perturbation up to a tiny quadratic range term — are
  evaluated on device in float32, and interpolation is a banded one-hot
  weight contraction (matmuls over G-chunks) against a small window of
  the score arrays. No gathers anywhere in the hot loop.

All dtypes: complex64 / float32 on device; float64 only on host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import C, F_CA, F_L1, L_CA

CODE_WIN = 16   # samples of code_corr kept around each channel's center.
# The position manifold spans ~+/-2 samples (|drange + dt| <~ 250 m at
# 0.00834 samples/m), so 16 leaves 4x margin while quartering the
# score-interpolation weight construction (the elementwise-bound hot loop).
CARR_WIN = 48   # carrier FFT bins kept around each channel's center.
# The velocity manifold spans ~+/-15 bins on the reference grids (|dv| +
# |dtdot| <~ 13.5 m/s at 1.1 bins per m/s), leaving ~+/-9 bins (~43 Hz) of
# carrier-prediction margin; the interpolation weight tensor over the grid
# is the HBM-bandwidth bottleneck, so width is traffic.
_SCORE_CHUNK = 16384  # grid points per interpolation chunk


def auto_windows(d_enu, dt_m, dv_enu, dtdot, fs: float,
                 carr_fftpts: int) -> tuple[int, int]:
    """Smallest safe (code_win, carr_win) for a given search grid.

    The scoring weight tensor is O(grid x channels x window width) of HBM
    traffic — the hot-path bottleneck — so the windows are sized to the
    grid geometry instead of a fixed worst case. Exactness bound: the
    3-tap interpolation reads k0-1..k0+1 with k0 = round(idx) clipped to
    [1, W-2]; no clipping occurs iff W >= 2*span + 4, where span is the
    max |idx - window center| =
      code:  (fs/c) * (max ||d_enu|| + curvature + max |dt|)
      carr:  (carr_fftpts/fs) * (f_L1/c) * (max ||dv_enu|| + max |dtdot|)
    (window centers are rounded to integers, covered by the +4; see
    models/dpe._prepare_block). A slack sample absorbs f32 index fuzz and
    the <~1e-5 fc-dependence of the code coefficient. The reference's
    fixed-size equivalent is the full [numChan x S] score array
    (batchcorrscores.cu:696-698) — it never pays this traffic because it
    materializes everything.
    """
    r_min = 1.9e7   # closest GPS range [m]; curvature term (d^2-u^2)/(2 r0)
    dmax = float(np.linalg.norm(d_enu, axis=1).max(initial=0.0))
    span_m = dmax + dmax * dmax / (2.0 * r_min) + float(
        np.abs(dt_m).max(initial=0.0))
    span_code = (fs / C) * 1.001 * span_m
    vmax = float(np.linalg.norm(dv_enu, axis=1).max(initial=0.0))
    span_carr = ((carr_fftpts / fs) * (F_L1 / C)
                 * (vmax + float(np.abs(dtdot).max(initial=0.0))))

    def _w(span):
        w = int(np.ceil(2.0 * span + 5.0))
        return max(8, (w + 3) // 4 * 4)     # multiple of 4, floor 8

    return _w(span_code), _w(span_carr)


class BlockScores(NamedTuple):
    code_corr: jax.Array   # [C, S] complex64, fftshifted
    carr_fft: jax.Array    # [C, F] complex64, fftshifted
    flip_used: jax.Array   # [C] bool


def _shift_phase(s: int, m_int: jax.Array, m_frac: jax.Array) -> jax.Array:
    """exp(2*pi*i*k*m/S) for the circular fractional advance by m samples.

    m = m_int + m_frac split so the f32 phase stays exact: the integer part
    wraps mod S in int32; the fractional part must ride the *signed*
    frequency axis (k - S for k >= S/2) or the upper half-spectrum chirps.
    """
    k = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1)
    ph_int = jnp.mod(k * m_int[:, None], np.int32(s)).astype(jnp.float32)
    k_signed = jnp.where(k >= s // 2, k - np.int32(s), k).astype(jnp.float32)
    ph = (ph_int * np.float32(1.0 / s)
          + (k_signed * np.float32(1.0 / s)) * m_frac[:, None])
    return jnp.exp(2j * jnp.pi * ph)


@functools.partial(jax.jit, static_argnames=("carr_fftpts",))
def batch_correlate(raw: jax.Array, code_fft0: jax.Array,
                    m_int: jax.Array, m_frac: jax.Array,
                    idx_next: jax.Array, fi: jax.Array, ri: jax.Array,
                    time_idc: jax.Array, carr_fftpts: int) -> BlockScores:
    """Batched code correlation + carrier FFT for one block.

    raw: [S] complex64 samples; code_fft0: [C, S] = fft of each channel's
    nominal (zero-phase) code replica; m_int/m_frac: integer/fractional parts
    of the per-channel replica shift in samples; idx_next: [C] first sample
    of the next nav bit (replica sign flips there; pass S for no flip);
    fi, ri: [C] Doppler / carrier phase.
    """
    s = raw.shape[0]
    wipeoff = jnp.exp(-2j * jnp.pi
                      * (fi[:, None] * time_idc[None, :] + ri[:, None]))
    bb = raw[None, :] * wipeoff                        # [C, S]
    rfft = jnp.fft.fft(bb, axis=-1)                    # [C, S]

    shift = _shift_phase(s, m_int, m_frac)
    repl_fft = code_fft0 * shift                       # [C, S]
    repl_time = jnp.real(jnp.fft.ifft(repl_fft, axis=-1))

    cols = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1)
    flip_mask = cols >= idx_next[:, None]
    repl_flip = jnp.where(flip_mask, -repl_time, repl_time)
    repl_flip_fft = jnp.fft.fft(repl_flip.astype(jnp.complex64), axis=-1)

    corr = jnp.fft.ifft(jnp.conj(repl_fft) * rfft, axis=-1)
    corr_f = jnp.fft.ifft(jnp.conj(repl_flip_fft) * rfft, axis=-1)

    use_flip = jnp.abs(corr_f[:, 0]) > jnp.abs(corr[:, 0])     # [C]
    code_corr = jnp.fft.fftshift(
        jnp.where(use_flip[:, None], corr_f, corr), axes=-1)

    repl = jnp.where(use_flip[:, None], repl_flip, repl_time)
    mean = jnp.mean(raw)
    carr_bb = (raw[None, :] - mean) * repl * wipeoff
    carr_fft = jnp.fft.fftshift(
        jnp.fft.fft(carr_bb, n=carr_fftpts, axis=-1), axes=-1)

    return BlockScores(code_corr=code_corr, carr_fft=carr_fft,
                       flip_used=use_flip)


class ManifoldParams(NamedTuple):
    """Per-channel scoring geometry, computed host-side in float64 per block.

    For grid point g with ENU offset d (meters) and clock offset dT (meters):
      code index(c, g)  = pos_center[c] + pos_coef[c] *
                          (-u + (|d|^2 - u^2) / (2 r0[c]) + dT)
      carr index(c, g)  = vel_center[c] + vel_coef[c] *
                          (-losENU[c] . dv + dTdot)
    where u = losENU[c] . d.
    """
    los_enu: jax.Array      # [C, 3] float32 unit LOS in ENU
    r0: jax.Array           # [C] float32 range to satellite [m]
    pos_center: jax.Array   # [C] float32 fractional index into the code win
    pos_coef: jax.Array     # [C] float32 (fs/fc)*(F_CA/C) [samples per meter]
    vel_center: jax.Array   # [C] float32 fractional index into the carr win
    vel_coef: jax.Array     # [C] float32 bins per (m/s)


def _interp_weights(idx: jax.Array, w: int, mode: str) -> jax.Array:
    """Banded interpolation weight tensor [..., W] for indices idx [...].

    mode="linear": hat weights (chord interpolation — reference parity,
    receiver.py:361-364 / batchcorrmanifold.cu:1806-1814; under-reads the
    correlation apex, which combined with the integer-snapping of the
    predicted state gives the reference estimator a dead zone around the
    prediction). mode="quadratic": 3-point Lagrange weights through the
    apex (default; no snap bias). mode="sinc": full-window Whittaker
    reconstruction — the pre-correlation signal is bandlimited below
    Nyquist, so the taps determine the continuous correlation exactly
    (up to window truncation); removes the 3-tap vertex bias that any
    local polynomial inherits at the kinked code apex. Used by the
    survey zoom passes, where integration has removed the noise that
    otherwise dominates it.
    """
    k = jax.lax.broadcasted_iota(jnp.float32, (1, 1, w), 2)
    if mode == "linear":
        return jnp.maximum(0.0, 1.0 - jnp.abs(idx[..., None] - k))
    if mode == "sinc":
        return jnp.sinc(idx[..., None] - k)
    k0 = jnp.clip(jnp.round(idx), 1.0, w - 2.0)
    d = idx - k0
    srel = k - k0[..., None]                       # integer-valued offsets
    d = d[..., None]
    w_m1 = 0.5 * (d * d - d)
    w_0 = 1.0 - d * d
    w_p1 = 0.5 * (d * d + d)
    return (jnp.where(srel == -1.0, w_m1, 0.0)
            + jnp.where(srel == 0.0, w_0, 0.0)
            + jnp.where(srel == 1.0, w_p1, 0.0))


def _interp_scores(win_mag: jax.Array, idx: jax.Array, mode: str,
                   l_power: int) -> jax.Array:
    """Sum over channels of interpolated window magnitudes.

    win_mag: [C, W] float32 (|complex| of the score window); idx: [C, G].
    Returns [G]. Chunked over G so the weight tensor stays small; each chunk
    is a contraction [C, CHUNK, W] x [C, W] -> [C, CHUNK].
    """
    c, g = idx.shape
    w = win_mag.shape[1]
    chunk = min(_SCORE_CHUNK, g)
    n_chunks = -(-g // chunk)
    pad = n_chunks * chunk - g
    idx_p = jnp.pad(idx, ((0, 0), (0, pad)))
    idx_ch = idx_p.reshape(c, n_chunks, chunk).transpose(1, 0, 2)

    def one(idx_c):                                  # [C, chunk]
        wgt = _interp_weights(idx_c, w, mode)        # [C, chunk, W]
        vals = jnp.einsum("cgw,cw->cg", wgt, win_mag,
                          preferred_element_type=jnp.float32)
        if l_power == 1:
            return jnp.sum(vals, axis=0)
        return jnp.sum(vals ** l_power, axis=0)

    out = jax.lax.map(one, idx_ch)                   # [n_chunks, chunk]
    return out.reshape(-1)[:g]


@functools.partial(jax.jit, static_argnames=("l_power", "interp"))
def score_manifolds(code_win: jax.Array, carr_win: jax.Array,
                    params: ManifoldParams,
                    d_enu: jax.Array, dt_m: jax.Array,
                    dv_enu: jax.Array, dtdot: jax.Array,
                    l_power: int = 1, interp: str = "quadratic"):
    """Score position and velocity manifolds; return scores + argmaxes.

    code_win: [C, CODE_WIN] complex64 — slice of code_corr around each
      channel's center index; carr_win: [C, CARR_WIN] likewise for carr_fft.
    d_enu: [Gp, 3] position offsets; dt_m: [Gp] clock offsets (meters);
    dv_enu: [Gv, 3] velocity offsets; dtdot: [Gv] drift offsets (m/s).

    Note: interpolation runs on |window| magnitudes. For mode="linear" the
    reference interpolates the complex values first; with the carrier wiped
    per channel the adjacent-bin phase is essentially constant, so the
    difference is far below the noise floor.
    """
    u = jnp.einsum("gj,cj->cg", d_enu, params.los_enu,
                   preferred_element_type=jnp.float32)        # [C, Gp]
    d2 = jnp.sum(d_enu * d_enu, axis=1)[None, :]              # [1, Gp]
    drange = -u + (d2 - u * u) / (2.0 * params.r0[:, None])
    pos_idx = (params.pos_center[:, None]
               + params.pos_coef[:, None] * (drange + dt_m[None, :]))
    pos_scores = _interp_scores(jnp.abs(code_win), pos_idx, interp, l_power)

    uv = jnp.einsum("gj,cj->cg", dv_enu, params.los_enu,
                    preferred_element_type=jnp.float32)       # [C, Gv]
    vel_idx = (params.vel_center[:, None]
               + params.vel_coef[:, None] * (-uv + dtdot[None, :]))
    vel_scores = _interp_scores(jnp.abs(carr_win), vel_idx, interp, l_power)

    return (pos_scores, jnp.argmax(pos_scores),
            vel_scores, jnp.argmax(vel_scores))


@functools.partial(jax.jit,
                   static_argnames=("carr_fftpts", "l_power", "interp",
                                    "code_win", "carr_win"))
def dpe_device_step(raw, code_fft0, m_int, m_frac, idx_next, fi, ri,
                    time_idc, pos_start, vel_start, params: ManifoldParams,
                    d_enu, dt_m, dv_enu, dtdot,
                    carr_fftpts: int, l_power: int = 1,
                    interp: str = "quadratic",
                    code_win: int = CODE_WIN, carr_win: int = CARR_WIN):
    """Fused device step: replica shift + batch correlate + manifold score.

    The single-jit flagship computation: one 20 ms block in, the two grid
    argmaxes (and peak scores) out. All per-channel scalars are traced, so
    one executable serves every block.
    """
    scores = batch_correlate(raw, code_fft0, m_int, m_frac, idx_next,
                             fi, ri, time_idc, carr_fftpts)

    def slice_one(arr, start, width):
        return jax.vmap(
            lambda row, st: jax.lax.dynamic_slice(row, (st,), (width,)))(
                arr, start)

    code_w = slice_one(scores.code_corr, pos_start, code_win)
    carr_w = slice_one(scores.carr_fft, vel_start, carr_win)

    pos_scores, pos_arg, vel_scores, vel_arg = score_manifolds(
        code_w, carr_w, params, d_enu, dt_m, dv_enu, dtdot,
        l_power=l_power, interp=interp)
    return (pos_scores, pos_arg, vel_scores, vel_arg, scores.flip_used)


def nominal_code_fft(chips: np.ndarray, fs: float, s: int) -> np.ndarray:
    """Host-side [C, S] FFT of each channel's nominal code replica
    (zero code phase, nominal chipping rate), float64 -> complex64."""
    t = np.arange(s) / fs
    idx = np.mod(np.floor(t * F_CA), L_CA).astype(np.int64)
    repl = chips[:, idx].astype(np.float64)          # [C, S]
    return np.fft.fft(repl, axis=-1).astype(np.complex64)


def replica_shift_parts(rc: np.ndarray, dfc: np.ndarray, fs: float,
                        T: float, s: int):
    """Split the replica shift m = (rc + dfc*T/2) * fs/F_CA into int32 +
    float32 parts (host float64)."""
    m = (rc + dfc * (T / 2.0)) * (fs / F_CA)
    m = np.mod(m, s)
    m_int = np.floor(m)
    m_frac = (m - m_int).astype(np.float32)
    return m_int.astype(np.int32), m_frac


def extract_windows(scores: BlockScores, pos_center_idx: np.ndarray,
                    vel_center_idx: np.ndarray):
    """Slice per-channel windows around integer center indices (host-driven,
    device-executed)."""
    c = scores.code_corr.shape[0]
    s = scores.code_corr.shape[1]
    f = scores.carr_fft.shape[1]

    pos_start = np.clip(pos_center_idx - CODE_WIN // 2, 0, s - CODE_WIN)
    vel_start = np.clip(vel_center_idx - CARR_WIN // 2, 0, f - CARR_WIN)

    code_win = jnp.stack([
        jax.lax.dynamic_slice(scores.code_corr[i], (int(pos_start[i]),),
                              (CODE_WIN,)) for i in range(c)])
    carr_win = jnp.stack([
        jax.lax.dynamic_slice(scores.carr_fft[i], (int(vel_start[i]),),
                              (CARR_WIN,)) for i in range(c)])
    return code_win, carr_win, pos_start, vel_start
