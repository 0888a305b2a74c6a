"""Real-arithmetic windowed DPE engine.

Mathematically identical to ops.dpe (batch correlation + zero-padded carrier
FFT + manifold scoring) but restricted to what the manifolds actually read:

- code correlation evaluated only at CODE_WIN lags around each channel's
  predicted center — via per-code-period folding (the C/A period is exactly
  T_CA*fs samples) and a tiny [C, W, period] lag contraction, with an exact
  boundary-arc correction for the nav-bit-flipped replica;
- carrier spectrum evaluated only at CARR_WIN bins of the zero-padded DFT —
  a two-stage (Cooley-Tukey style) windowed DFT as small matmuls with
  integer-exact twiddle phases.

Everything is float32/int32: no complex dtypes, no gathers, no full-length
FFTs — immune to backend gaps in complex/gather support, and cheaper than
the full-FFT path because the 99.9% of the correlation/spectrum the
manifolds never read is never computed.

Replica generation is a one-hot chip-lookup matmul over a single code
period, tiled across the block (drift over 20 ms is < 0.1 chip and is
centered by evaluating the code phase mid-block).

Parity anchors: correlator.vector_correlate_unfolded (correlator.py:367-465),
BatchCorrScores (batchcorrscores.cu:975-1207), BCM scoring
(batchcorrmanifold.cu:1710-1963).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import F_CA, L_CA
from .dpe import (CARR_WIN, CODE_WIN, ManifoldParams, _interp_scores,
                  _interp_weights)

_SLIVER = 128  # samples around the nav-bit boundary handled exactly
# the boundary-arc flip correction is exact only for window lags
# |m| <= _SLIVER/2; receivers must keep code_win within this span
SLIVER_LIMIT = _SLIVER


@functools.lru_cache(maxsize=4)
def _chip_lookup_consts(period: int):
    """Compile-time constant chip-lookup tables for one code period.

    The engine already requires period == T_CA * fs exactly (the fold step),
    so the nominal per-sample chip index is base0[k] = k * L_CA / period.
    With code phase rc, floor(base0[k] + rc) = floor(base0[k]) + floor(rc)
    + carry(k, rc) where carry = [frac(base0[k]) + frac(rc) >= 1]. The two
    integer patterns floor(base0) and floor(base0)+1 are data-independent:
    the lookup becomes two CONSTANT one-hot matmuls applied to the chip
    sequence rolled by floor(rc) — eliminating the old per-block
    [C, P0, 1023] one-hot equality tensor (~80 MB of HBM traffic/block).
    Returns numpy (e0 [P0, L_CA], e1 [P0, L_CA], frac_base [P0]).
    """
    l_ca = int(L_CA)
    base0 = (np.arange(period) * float(l_ca) / period).astype(np.float32)
    floor_base = np.floor(base0).astype(np.int64)
    frac_base = (base0 - floor_base.astype(np.float32)).astype(np.float32)
    e0 = np.zeros((period, l_ca), np.float32)
    e0[np.arange(period), floor_base % l_ca] = 1.0
    e1 = np.zeros((period, l_ca), np.float32)
    e1[np.arange(period), (floor_base + 1) % l_ca] = 1.0
    return e0, e1, frac_base


def _period_replicas(chips, rc_mid, period: int):
    """One-period +/-1 replicas via constant one-hot matmuls (no gather).

    chips: [C, 1023] f32; rc_mid: [C] f32 code phase (mid-block);
    period: static samples per code period. Returns [C, P0] f32.
    """
    e0_np, e1_np, frac_base_np = _chip_lookup_consts(period)
    e0 = jnp.asarray(e0_np)
    e1 = jnp.asarray(e1_np)
    frac_base = jnp.asarray(frac_base_np)
    l_ca = int(L_CA)

    shift = jnp.floor(rc_mid).astype(jnp.int32)           # [C]
    frac_rc = rc_mid - jnp.floor(rc_mid)                  # [C]
    chips2 = jnp.concatenate([chips, chips], axis=1)      # [C, 2*1023]

    # circular roll by `shift` via a two-stage one-hot contraction instead
    # of a vmapped dynamic_slice (which lowers to a gather over a shared
    # operand). shift = 32*a + b; stage b is 32 static slices of the chips
    # (loop-invariant, hoisted), stage a 32 static slices of the
    # per-block intermediate.
    sh = jnp.mod(shift, l_ca)
    sh_a, sh_b = sh // 32, sh % 32
    n_sub = 32
    ext_b = jnp.stack([chips2[:, b:b + l_ca + (n_sub - 1) * 32]
                       for b in range(n_sub)], axis=1)    # [C, 32, 2015]
    bi = jax.lax.broadcasted_iota(jnp.int32, (1, n_sub), 1)
    oh_b = (bi == sh_b[:, None]).astype(jnp.float32)      # [C, 32]
    y = jnp.einsum("cb,cbj->cj", oh_b, ext_b,
                   preferred_element_type=jnp.float32)    # [C, 2015]
    ext_a = jnp.stack([y[:, 32 * a:32 * a + l_ca]
                       for a in range(n_sub)], axis=1)    # [C, 32, 1023]
    oh_a = (bi == sh_a[:, None]).astype(jnp.float32)
    rolled = jnp.einsum("ca,caj->cj", oh_a, ext_a,
                        preferred_element_type=jnp.float32)  # [C, 1023]
    r0 = jnp.einsum("pk,ck->cp", e0, rolled,
                    preferred_element_type=jnp.float32)   # [C, P0]
    r1 = jnp.einsum("pk,ck->cp", e1, rolled,
                    preferred_element_type=jnp.float32)
    carry = ((frac_base[None, :] + frac_rc[:, None])
             >= np.float32(1.0)).astype(jnp.float32)      # [C, P0]
    return r0 + carry * (r1 - r0)


def _lag_matrix(period_repl, m_signed):
    """[C, W, P0] replica rows shifted by each window lag.

    period_repl: [C, P0]; m_signed: [C, W] int32 signed lags. Row (c, l) is
    p_c[(q - m) mod P0] over q.
    """
    p0 = period_repl.shape[1]
    repl2 = jnp.concatenate([period_repl, period_repl], axis=1)  # [C, 2*P0]
    start = jnp.mod(p0 - m_signed, p0)                    # [C, W]

    def slice_cl(row, st):
        return jax.lax.dynamic_slice(row, (st,), (p0,))

    return jax.vmap(jax.vmap(slice_cl, in_axes=(None, 0)),
                    in_axes=(0, 0))(repl2, start)          # [C, W, P0]


def _dft_twiddles(vel_start, f_total: int, s1_n: int, s0_n: int,
                  carr_win: int):
    """Two-stage windowed-DFT twiddle tables with integer-exact phases.

    Bin j of the (fftshifted) carrier window maps to DFT bin
    k = (vel_start + j - F/2) mod F. Stage split: s = s0_n * s1 + s0.
    Returns (a_cos, a_sin, b_cos, b_sin): [C, W, s1_n] and [C, W, s0_n].
    """
    j = jax.lax.broadcasted_iota(jnp.int32, (1, carr_win), 1)
    k = jnp.mod(vel_start[:, None] + j - np.int32(f_total // 2),
                np.int32(f_total))                        # [C, W]

    s1 = jax.lax.broadcasted_iota(jnp.int32, (1, 1, s1_n), 2)
    k256 = jnp.mod(k * np.int32(s0_n), np.int32(f_total))  # [C, W]
    ph_a = jnp.mod(k256[:, :, None] * s1, np.int32(f_total)).astype(jnp.float32)
    ang_a = ph_a * np.float32(2.0 * np.pi / f_total)

    s0 = jax.lax.broadcasted_iota(jnp.int32, (1, 1, s0_n), 2)
    ph_b = jnp.mod(k[:, :, None] * s0, np.int32(f_total)).astype(jnp.float32)
    ang_b = ph_b * np.float32(2.0 * np.pi / f_total)
    return (jnp.cos(ang_a), jnp.sin(ang_a), jnp.cos(ang_b), jnp.sin(ang_b))


class RealBlockOut(NamedTuple):
    code_mag: jax.Array    # [C, code_win]
    carr_mag: jax.Array    # [C, carr_win]
    flip_used: jax.Array   # [C]


class RealBlockOutC(NamedTuple):
    """Complex (split re/im) window variant — for coherent integration."""
    code_re: jax.Array     # [C, code_win]
    code_im: jax.Array
    carr_re: jax.Array     # [C, carr_win]
    carr_im: jax.Array
    flip_used: jax.Array   # [C]


@functools.partial(jax.jit,
                   static_argnames=("carr_fftpts", "period", "n_periods",
                                    "code_win", "carr_win", "complex_out"))
def _windowed_correlate_direct(raw_re, raw_im, chips, base0, rc_mid, idx_next,
                               fi, ri, time_idc, pos_start, vel_start,
                               carr_fftpts: int, period: int, n_periods: int,
                               code_win: int = CODE_WIN,
                               carr_win: int = CARR_WIN,
                               complex_out: bool = False):
    """Direct (unfactorized) windowed correlator — the straightforward
    form: carrier-wipe the full [C, S] baseband, fold, correlate. Kept as
    the equivalence oracle for `windowed_correlate`, whose period-factorized
    carrier algebra is ~5x cheaper but less obviously correct.
    """
    s = raw_re.shape[0]
    c = chips.shape[0]

    # carrier wipeoff (w = exp(-2pi i (fi t + ri)))
    ang = 2.0 * jnp.pi * (fi[:, None] * time_idc[None, :] + ri[:, None])
    wc, ws = jnp.cos(ang), jnp.sin(ang)
    bb_re = raw_re[None, :] * wc + raw_im[None, :] * ws     # [C, S]
    bb_im = raw_im[None, :] * wc - raw_re[None, :] * ws

    # one-period replicas, tiled (base0 retained in the signature for API
    # stability; the lookup tables are compile-time constants of `period`)
    del base0
    p_repl = _period_replicas(chips, rc_mid, period)        # [C, P0]
    repl = jnp.tile(p_repl, (1, n_periods))                 # [C, S]

    cols = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1)
    tail = (cols >= idx_next[:, None]).astype(jnp.float32)  # [C, S]

    # fold bb by code period: plain and tail-masked
    def fold(x):
        return jnp.sum(x.reshape(c, n_periods, period), axis=1)

    fold_re = fold(bb_re)
    fold_im = fold(bb_im)
    # product terms for the flip correction: bb * tail
    fold_tail_re = fold(bb_re * tail)
    fold_tail_im = fold(bb_im * tail)

    # window lags
    l = jax.lax.broadcasted_iota(jnp.int32, (1, code_win), 1)
    m_signed = pos_start[:, None] + l - np.int32(s // 2)    # [C, W]
    lag = _lag_matrix(p_repl, jnp.mod(m_signed, period))    # [C, W, P0]

    def corr_with(fr, fi_):
        re = jnp.einsum("cwp,cp->cw", lag, fr,
                        preferred_element_type=jnp.float32)
        im = jnp.einsum("cwp,cp->cw", lag, fi_,
                        preferred_element_type=jnp.float32)
        return re, im

    nf_re, nf_im = corr_with(fold_re, fold_im)              # no-flip window
    t_re, t_im = corr_with(fold_tail_re, fold_tail_im)      # tail part

    # boundary-arc correction: the flip boundary in replica coordinates
    # shifts by the lag m; handle the +/- _SLIVER samples around idx_next
    # exactly. samples s in [idx_next + min(m), idx_next + max(m)) change
    # their tail membership depending on m.
    half = _SLIVER // 2
    sl_start = jnp.clip(idx_next - half, 0, s - _SLIVER)    # [C]

    def slice_c(row, st):
        return jax.lax.dynamic_slice(row, (st,), (_SLIVER,))

    sliver_re = jax.vmap(slice_c)(bb_re, sl_start)          # [C, SLIVER]
    sliver_im = jax.vmap(slice_c)(bb_im, sl_start)
    sliver_pos = sl_start[:, None] + jax.lax.broadcasted_iota(
        jnp.int32, (1, _SLIVER), 1)                         # [C, SLIVER]

    # membership with lag m: flipped iff (s - m) mod S >= idx_next; for
    # |m| << S this is s >= idx_next + m away from the wrap.
    in_tail_m = (sliver_pos[:, None, :]
                 >= (idx_next[:, None] + m_signed)[:, :, None])  # [C, W, SL]
    in_tail_0 = (sliver_pos >= idx_next[:, None])           # [C, SL]
    delta = in_tail_m.astype(jnp.float32) - in_tail_0[:, None, :]

    # lag-shifted replica over the sliver: the sliver samples are
    # consecutive, so p_c[(q - m) mod P0] is a contiguous slice of the
    # period-doubled replica starting at (sl_start - m) mod P0.
    repl2 = jnp.concatenate([p_repl, p_repl], axis=1)       # [C, 2*P0]
    sl_q0 = jnp.mod(sl_start[:, None] - m_signed, period)   # [C, W]

    def slice_cw(row, st):
        return jax.lax.dynamic_slice(row, (st,), (_SLIVER,))

    sliver_repl_m = jax.vmap(jax.vmap(slice_cw, in_axes=(None, 0)),
                             in_axes=(0, 0))(repl2, sl_q0)  # [C, W, SLIVER]

    corr_t_re = t_re + jnp.sum(
        delta * sliver_re[:, None, :] * sliver_repl_m, axis=2)
    corr_t_im = t_im + jnp.sum(
        delta * sliver_im[:, None, :] * sliver_repl_m, axis=2)

    fl_re = nf_re - 2.0 * corr_t_re                         # flip window
    fl_im = nf_im - 2.0 * corr_t_im

    # flip decision at lag 0 (reference: |corr[0]|, correlator.py:410)
    c0nf_re = jnp.sum(bb_re * repl, axis=1)
    c0nf_im = jnp.sum(bb_im * repl, axis=1)
    flip_sign = 1.0 - 2.0 * tail
    c0fl_re = jnp.sum(bb_re * repl * flip_sign, axis=1)
    c0fl_im = jnp.sum(bb_im * repl * flip_sign, axis=1)
    use_flip = (c0fl_re ** 2 + c0fl_im ** 2) > (c0nf_re ** 2 + c0nf_im ** 2)

    w_re = jnp.where(use_flip[:, None], fl_re, nf_re)
    w_im = jnp.where(use_flip[:, None], fl_im, nf_im)
    if not complex_out:
        code_mag = jnp.sqrt(w_re * w_re + w_im * w_im)

    # ---- carrier windowed DFT --------------------------------------------
    repl_chosen = jnp.where(use_flip[:, None], repl * flip_sign, repl)
    mean_re = jnp.mean(raw_re)
    mean_im = jnp.mean(raw_im)
    y_base_re = (raw_re[None, :] - mean_re) * repl_chosen
    y_base_im = (raw_im[None, :] - mean_im) * repl_chosen
    y_re = y_base_re * wc + y_base_im * ws
    y_im = y_base_im * wc - y_base_re * ws

    s0_n = 256
    s1_n = -(-s // s0_n)
    pad = s1_n * s0_n - s
    y_re_p = jnp.pad(y_re, ((0, 0), (0, pad))).reshape(c, s1_n, s0_n)
    y_im_p = jnp.pad(y_im, ((0, 0), (0, pad))).reshape(c, s1_n, s0_n)

    a_cos, a_sin, b_cos, b_sin = _dft_twiddles(vel_start, carr_fftpts,
                                               s1_n, s0_n, carr_win)
    # stage 1: Z[c, w, s0] = sum_s1 y[s1, s0] * e^{-i ang_a(w, s1)}
    z_re = (jnp.einsum("cws,cst->cwt", a_cos, y_re_p,
                       preferred_element_type=jnp.float32)
            + jnp.einsum("cws,cst->cwt", a_sin, y_im_p,
                         preferred_element_type=jnp.float32))
    z_im = (jnp.einsum("cws,cst->cwt", a_cos, y_im_p,
                       preferred_element_type=jnp.float32)
            - jnp.einsum("cws,cst->cwt", a_sin, y_re_p,
                         preferred_element_type=jnp.float32))
    # stage 2: X[c, w] = sum_s0 Z[c, w, s0] * e^{-i ang_b(w, s0)}
    x_re = jnp.sum(z_re * b_cos + z_im * b_sin, axis=2)
    x_im = jnp.sum(z_im * b_cos - z_re * b_sin, axis=2)
    if complex_out:
        return RealBlockOutC(code_re=w_re, code_im=w_im,
                             carr_re=x_re, carr_im=x_im, flip_used=use_flip)
    carr_mag = jnp.sqrt(x_re * x_re + x_im * x_im)

    return RealBlockOut(code_mag=code_mag, carr_mag=carr_mag,
                        flip_used=use_flip)


def _dft_twiddles_mixed(vel_start, fi, ri, dt_s, f_total: int, s1_n: int,
                        s0_n: int, carr_win: int, t0=0.0):
    """Two-stage (s0_n-way split) carrier-DFT twiddles with the wipeoff
    folded in.

    Combined phase per sample: the integer-exact window-bin phase
    2*pi*(k*s mod F)/F PLUS the carrier-wipeoff phase
    2*pi*(fi*(t0 + s*dt) + ri), split over s = s0_n*s1 + s0. This split
    materializes the full-length wipeoff product but keeps the per-stage
    intermediates tiny ([C, W, 256]). It measured faster on an H100 than
    a split along the code period that never forms the [C, S] product."""
    j = jax.lax.broadcasted_iota(jnp.int32, (1, carr_win), 1)
    k = jnp.mod(vel_start[:, None] + j - np.int32(f_total // 2),
                np.int32(f_total))                        # [C, W]
    two_pi = np.float32(2.0 * np.pi)

    s1 = jax.lax.broadcasted_iota(jnp.int32, (1, 1, s1_n), 2)
    k256 = jnp.mod(k * np.int32(s0_n), np.int32(f_total))  # [C, W]
    ph_a = jnp.mod(k256[:, :, None] * s1, np.int32(f_total)).astype(jnp.float32)
    t_a = (s1.astype(jnp.float32) * np.float32(s0_n)) * dt_s
    ang_a = (ph_a * np.float32(2.0 * np.pi / f_total)
             + two_pi * fi[:, None, None] * t_a)

    s0 = jax.lax.broadcasted_iota(jnp.int32, (1, 1, s0_n), 2)
    ph_b = jnp.mod(k[:, :, None] * s0, np.int32(f_total)).astype(jnp.float32)
    t_b = t0 + s0.astype(jnp.float32) * dt_s
    ang_b = (ph_b * np.float32(2.0 * np.pi / f_total)
             + two_pi * (fi[:, None, None] * t_b + ri[:, None, None]))
    return (jnp.cos(ang_a), jnp.sin(ang_a), jnp.cos(ang_b), jnp.sin(ang_b))


@functools.partial(jax.jit,
                   static_argnames=("carr_fftpts", "period", "n_periods",
                                    "code_win", "carr_win", "complex_out"))
def windowed_correlate(raw_re, raw_im, chips, base0, rc_mid, idx_next,
                       fi, ri, time_idc, pos_start, vel_start,
                       carr_fftpts: int, period: int, n_periods: int,
                       code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                       complex_out: bool = False):
    """Windowed code correlation + windowed carrier DFT (all-real,
    period-factorized).

    raw_re/raw_im: [S]; chips: [C, 1023]; base0: [period] nominal chip
    indices; rc_mid: [C] mid-block code phase; idx_next: [C] nav-bit flip
    sample (S for none); fi/ri: [C]; pos_start/vel_start: [C] window origins
    (fftshifted index space). code_win/carr_win: window widths — sized to
    the grid via ops.dpe.auto_windows. complex_out keeps the window re/im
    parts (RealBlockOutC) so blocks can be summed coherently.

    The correlator exploits ang(s) = A(p) + B(tau) for s = p*P0 + tau
    (the carrier phase is affine in time): the code fold over periods
    becomes a [C, n_periods] complex-weighted contraction of the SHARED
    [n_periods, P0] raw reshape followed by one [C, P0] rotation, the
    nav-bit tail fold the same with masked weights plus one exact
    boundary-period term, the lag-0 flip decision reads off the folds, and
    the carrier wipeoff folds into the DFT twiddles of a 256-way mixed
    split (_dft_twiddles_mixed). Contract: time_idc must be
    uniform/affine (t0 + s*dt); t0 may be nonzero (e.g. io/rawfile.py
    samp_idc/fs mid-file). Equivalence to the direct form
    (_windowed_correlate_direct) is tested in tests/test_dpe_real.py
    (test_windowed_matches_direct) and on the GPU by chip_smoke.py: the
    fold contractions run at JAX's default matmul precision, which a GPU
    may execute as TF32, so agreement there is at the ~1e-4-relative
    class, with identical argmaxes and flip decisions; on CPU it is
    f32-reassociation-exact (~1e-6)."""
    s = raw_re.shape[0]
    c = chips.shape[0]
    two_pi = np.float32(2.0 * np.pi)

    # one-period replicas (base0 retained in the signature for API
    # stability; the lookup tables are compile-time constants of `period`)
    del base0
    p_repl = _period_replicas(chips, rc_mid, period)        # [C, P0]

    # per-period carrier factorization: ang(s) = A(p) + B(tau). The time
    # origin t0 = time_idc[0] rides in B (t_tau keeps it); A uses the
    # origin-free period offsets so A(p) + B(tau) == 2*pi*fi*time_idc[s]
    # + ri exactly — matching the direct form for ANY affine time vector
    # (e.g. io/rawfile.py samp_idc/fs starting mid-file), not just
    # time_idc[0] == 0. Contract: time_idc must be uniform (t0 + s*dt);
    # the sliver below reconstructs phase from (t0, dt).
    tt = time_idc[: n_periods * period].reshape(n_periods, period)
    t_p = tt[:, 0] - time_idc[0]                            # [P]
    t_tau = tt[0]                                           # [P0]
    ang_a = two_pi * fi[:, None] * t_p[None, :]             # [C, P]
    ca_, sa_ = jnp.cos(ang_a), jnp.sin(ang_a)
    ang_b = two_pi * (fi[:, None] * t_tau[None, :] + ri[:, None])
    cb_, sb_ = jnp.cos(ang_b), jnp.sin(ang_b)               # [C, P0]

    raw_p = raw_re.reshape(n_periods, period)               # shared
    raw_ip = raw_im.reshape(n_periods, period)

    # tail membership by period: periods strictly after the boundary
    # period p_b flip whole; p_b itself flips from sample offset r_off
    p_b = idx_next // np.int32(period)                      # [C]
    r_off = idx_next - p_b * np.int32(period)               # [C]
    p_idx = jax.lax.broadcasted_iota(jnp.int32, (1, n_periods), 1)
    maskp = (p_idx > p_b[:, None]).astype(jnp.float32)      # [C, P]

    # folds: sum_p raw(p,tau) e^{-iA_p} (plain + tail-masked) in one pair
    # of [4C, P] x [P, P0] contractions over the shared raw reshape
    wts = jnp.concatenate([ca_, sa_, ca_ * maskp, sa_ * maskp], axis=0)
    fr = jnp.einsum("kp,pt->kt", wts, raw_p,
                    preferred_element_type=jnp.float32)     # [4C, P0]
    fq = jnp.einsum("kp,pt->kt", wts, raw_ip,
                    preferred_element_type=jnp.float32)
    rs_re = fr[0:c] + fq[c:2 * c]                           # [C, P0]
    rs_im = fq[0:c] - fr[c:2 * c]
    ts_re = fr[2 * c:3 * c] + fq[3 * c:4 * c]
    ts_im = fq[2 * c:3 * c] - fr[3 * c:4 * c]

    # exact boundary-period tail term: step(tau >= r_off) * raw(p_b, tau)
    p_bc = jnp.clip(p_b, 0, n_periods - 1)
    valid = ((p_b >= 0) & (p_b < n_periods)).astype(jnp.float32)

    def row_at(mat, st):
        return jax.lax.dynamic_slice(mat, (st, 0), (1, mat.shape[1]))[0]

    raw_b_re = jax.vmap(row_at, in_axes=(None, 0))(raw_p, p_bc)   # [C, P0]
    raw_b_im = jax.vmap(row_at, in_axes=(None, 0))(raw_ip, p_bc)

    def at_p(row, st):
        return jax.lax.dynamic_slice(row, (st,), (1,))[0]

    ca_b = jax.vmap(at_p)(ca_, p_bc)                        # [C]
    sa_b = jax.vmap(at_p)(sa_, p_bc)
    tau_idx = jax.lax.broadcasted_iota(jnp.int32, (1, period), 1)
    gmask = valid[:, None] * (tau_idx >= r_off[:, None]).astype(jnp.float32)
    ts_re = ts_re + gmask * (ca_b[:, None] * raw_b_re
                             + sa_b[:, None] * raw_b_im)
    ts_im = ts_im + gmask * (ca_b[:, None] * raw_b_im
                             - sa_b[:, None] * raw_b_re)

    # rotate by e^{-iB(tau)}: the folded baseband and its tail part
    fold_re = rs_re * cb_ + rs_im * sb_
    fold_im = rs_im * cb_ - rs_re * sb_
    fold_tail_re = ts_re * cb_ + ts_im * sb_
    fold_tail_im = ts_im * cb_ - ts_re * sb_

    # window lags: m_w = m0 + w is CONSECUTIVE in w, so the W lag rows are
    # consecutive shifts of one periodic slice — one dynamic slice per
    # channel + W static shifts, instead of W vmapped dynamic slices per
    # channel (each a gather)
    l = jax.lax.broadcasted_iota(jnp.int32, (1, code_win), 1)
    m0 = pos_start - np.int32(s // 2)                       # [C] first lag
    m_signed = m0[:, None] + l                              # [C, W]
    st_last = jnp.mod(np.int32(period) - m0 - np.int32(code_win - 1),
                      np.int32(period))                     # [C]
    repl_ext = jnp.concatenate([p_repl, p_repl, p_repl[:, :code_win]],
                               axis=1)                      # [C, 2*P0+W]

    def sl_ext(row, st):
        return jax.lax.dynamic_slice(row, (st,), (period + code_win - 1,))

    ext = jax.vmap(sl_ext)(repl_ext, st_last)               # [C, P0+W-1]
    lag = jnp.stack([ext[:, code_win - 1 - w: code_win - 1 - w + period]
                     for w in range(code_win)], axis=1)     # [C, W, P0]

    def corr_with(frr, fii):
        re = jnp.einsum("cwp,cp->cw", lag, frr,
                        preferred_element_type=jnp.float32)
        im = jnp.einsum("cwp,cp->cw", lag, fii,
                        preferred_element_type=jnp.float32)
        return re, im

    nf_re, nf_im = corr_with(fold_re, fold_im)              # no-flip window
    t_re, t_im = corr_with(fold_tail_re, fold_tail_im)      # tail part

    # boundary-arc correction (identical to the direct form): the flip
    # boundary in replica coordinates shifts by the lag m; handle the
    # +/- _SLIVER samples around idx_next exactly. The baseband is
    # rebuilt over the sliver only ([C, _SLIVER]).
    half = _SLIVER // 2
    sl_start = jnp.clip(idx_next - half, 0, s - _SLIVER)    # [C]

    def slice_c(row, st):
        return jax.lax.dynamic_slice(row, (st,), (_SLIVER,))

    raw_sl_re = jax.vmap(slice_c, in_axes=(None, 0))(raw_re, sl_start)
    raw_sl_im = jax.vmap(slice_c, in_axes=(None, 0))(raw_im, sl_start)
    # sliver sample times arithmetically (slicing the shared time_idc with
    # per-channel starts would lower to an emulated gather; t0 + f32(s)*dt
    # matches time_idc's own arange/fs rounding class AND its origin, so
    # the sliver phase is consistent with the period folds above for any
    # affine time vector). dt from the ENDPOINTS: adjacent-sample f32
    # differences lose ~2% relative accuracy once t0 >> dt (ulp(t0) ~ dt).
    dt_s0 = (time_idc[s - 1] - time_idc[0]) / np.float32(s - 1)
    j_sl = jax.lax.broadcasted_iota(jnp.int32, (1, _SLIVER), 1)
    t_sl = (time_idc[0]
            + (sl_start[:, None] + j_sl).astype(jnp.float32) * dt_s0)
    ang_sl = two_pi * (fi[:, None] * t_sl + ri[:, None])    # [C, SLIVER]
    wc_sl, ws_sl = jnp.cos(ang_sl), jnp.sin(ang_sl)
    sliver_re = raw_sl_re * wc_sl + raw_sl_im * ws_sl
    sliver_im = raw_sl_im * wc_sl - raw_sl_re * ws_sl
    sliver_pos = sl_start[:, None] + jax.lax.broadcasted_iota(
        jnp.int32, (1, _SLIVER), 1)                         # [C, SLIVER]

    in_tail_m = (sliver_pos[:, None, :]
                 >= (idx_next[:, None] + m_signed)[:, :, None])  # [C, W, SL]
    in_tail_0 = (sliver_pos >= idx_next[:, None])           # [C, SL]
    delta = in_tail_m.astype(jnp.float32) - in_tail_0[:, None, :]

    # same consecutive-lag trick for the sliver's lag-shifted replicas:
    # sl_q0(w) = mod(sl_start - m0 - w, P0) — one slice + W static shifts
    st2_last = jnp.mod(sl_start - m0 - np.int32(code_win - 1), period)
    repl_ext2 = jnp.concatenate(
        [p_repl, p_repl[:, :_SLIVER + code_win]], axis=1)

    def sl_ext2(row, st):
        return jax.lax.dynamic_slice(row, (st,), (_SLIVER + code_win - 1,))

    ext2 = jax.vmap(sl_ext2)(repl_ext2, st2_last)           # [C, SL+W-1]
    sliver_repl_m = jnp.stack(
        [ext2[:, code_win - 1 - w: code_win - 1 - w + _SLIVER]
         for w in range(code_win)], axis=1)                 # [C, W, SLIVER]
    corr_t_re = t_re + jnp.sum(
        delta * sliver_re[:, None, :] * sliver_repl_m, axis=2)
    corr_t_im = t_im + jnp.sum(
        delta * sliver_im[:, None, :] * sliver_repl_m, axis=2)

    fl_re = nf_re - 2.0 * corr_t_re                         # flip window
    fl_im = nf_im - 2.0 * corr_t_im

    # flip decision at lag 0 (reference: |corr[0]|, correlator.py:410) —
    # read off the folds: sum_s bb*repl = sum_tau p_repl*fold_bb, and the
    # tail part likewise (both exact at lag 0; no full-S pass)
    c0nf_re = jnp.sum(p_repl * fold_re, axis=1)
    c0nf_im = jnp.sum(p_repl * fold_im, axis=1)
    c0t_re = jnp.sum(p_repl * fold_tail_re, axis=1)
    c0t_im = jnp.sum(p_repl * fold_tail_im, axis=1)
    c0fl_re = c0nf_re - 2.0 * c0t_re
    c0fl_im = c0nf_im - 2.0 * c0t_im
    use_flip = (c0fl_re ** 2 + c0fl_im ** 2) > (c0nf_re ** 2 + c0nf_im ** 2)

    w_re = jnp.where(use_flip[:, None], fl_re, nf_re)
    w_im = jnp.where(use_flip[:, None], fl_im, nf_im)
    if not complex_out:
        code_mag = jnp.sqrt(w_re * w_re + w_im * w_im)

    # ---- carrier windowed DFT (wipeoff folded into the twiddles) --------
    mean_re = jnp.mean(raw_re)
    mean_im = jnp.mean(raw_im)
    dt_s = (time_idc[s - 1] - time_idc[0]) / np.float32(s - 1)
    repl = jnp.tile(p_repl, (1, n_periods))                 # [C, S]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1)
    flip_sign = 1.0 - 2.0 * (cols >= idx_next[:, None]).astype(jnp.float32)
    repl_chosen = jnp.where(use_flip[:, None], repl * flip_sign, repl)
    yb_re = (raw_re[None, :] - mean_re) * repl_chosen       # [C, S]
    yb_im = (raw_im[None, :] - mean_im) * repl_chosen
    s0_n = 256
    s1_n = -(-s // s0_n)
    pad = s1_n * s0_n - s
    yb_re_p = jnp.pad(yb_re, ((0, 0), (0, pad))).reshape(c, s1_n, s0_n)
    yb_im_p = jnp.pad(yb_im, ((0, 0), (0, pad))).reshape(c, s1_n, s0_n)
    a_cos, a_sin, b_cos, b_sin = _dft_twiddles_mixed(
        vel_start, fi, ri, dt_s, carr_fftpts, s1_n, s0_n, carr_win,
        t0=time_idc[0])
    z_re = (jnp.einsum("cws,cst->cwt", a_cos, yb_re_p,
                       preferred_element_type=jnp.float32)
            + jnp.einsum("cws,cst->cwt", a_sin, yb_im_p,
                         preferred_element_type=jnp.float32))
    z_im = (jnp.einsum("cws,cst->cwt", a_cos, yb_im_p,
                       preferred_element_type=jnp.float32)
            - jnp.einsum("cws,cst->cwt", a_sin, yb_re_p,
                         preferred_element_type=jnp.float32))
    x_re = jnp.sum(z_re * b_cos + z_im * b_sin, axis=2)
    x_im = jnp.sum(z_im * b_cos - z_re * b_sin, axis=2)
    if complex_out:
        return RealBlockOutC(code_re=w_re, code_im=w_im,
                             carr_re=x_re, carr_im=x_im, flip_used=use_flip)
    carr_mag = jnp.sqrt(x_re * x_re + x_im * x_im)
    return RealBlockOut(code_mag=code_mag, carr_mag=carr_mag,
                        flip_used=use_flip)


@functools.partial(jax.jit, static_argnames=("l_power", "interp"))
def score_manifolds_mag(code_mag, carr_mag, params: ManifoldParams,
                        d_enu, dt_m, dv_enu, dtdot,
                        l_power: int = 1, interp: str = "quadratic"):
    """score_manifolds over magnitude windows (all-real)."""
    u = jnp.einsum("gj,cj->cg", d_enu, params.los_enu,
                   preferred_element_type=jnp.float32)
    d2 = jnp.sum(d_enu * d_enu, axis=1)[None, :]
    drange = -u + (d2 - u * u) / (2.0 * params.r0[:, None])
    pos_idx = (params.pos_center[:, None]
               + params.pos_coef[:, None] * (drange + dt_m[None, :]))
    pos_scores = _interp_scores(code_mag, pos_idx, interp, l_power)

    uv = jnp.einsum("gj,cj->cg", dv_enu, params.los_enu,
                    preferred_element_type=jnp.float32)
    vel_idx = (params.vel_center[:, None]
               + params.vel_coef[:, None] * (-uv + dtdot[None, :]))
    vel_scores = _interp_scores(carr_mag, vel_idx, interp, l_power)

    return (pos_scores, jnp.argmax(pos_scores),
            vel_scores, jnp.argmax(vel_scores))


@functools.partial(jax.jit, static_argnames=("carr_fftpts", "period",
                                             "n_periods", "l_power",
                                             "interp", "code_win",
                                             "carr_win"))
def dpe_device_step_real(raw_re, raw_im, chips, base0, rc_mid, idx_next,
                         fi, ri, time_idc, pos_start, vel_start,
                         params: ManifoldParams,
                         d_enu, dt_m, dv_enu, dtdot,
                         carr_fftpts: int, period: int, n_periods: int,
                         l_power: int = 1, interp: str = "quadratic",
                         code_win: int = CODE_WIN, carr_win: int = CARR_WIN):
    """Fused all-real DPE block step (windowed engine)."""
    out = windowed_correlate(raw_re, raw_im, chips, base0, rc_mid, idx_next,
                             fi, ri, time_idc, pos_start, vel_start,
                             carr_fftpts, period, n_periods,
                             code_win=code_win, carr_win=carr_win)
    pos_scores, pos_arg, vel_scores, vel_arg = score_manifolds_mag(
        out.code_mag, out.carr_mag, params, d_enu, dt_m, dv_enu, dtdot,
        l_power=l_power, interp=interp)
    return (pos_scores, pos_arg, vel_scores, vel_arg, out.flip_used,
            out.code_mag, out.carr_mag)


# ---------------------------------------------------------------------------
# Batched multi-block scan (deferred feedback).
#
# Every host->device transfer and dispatch has a fixed cost, so the batched
# loop packs all per-channel parameters for N blocks into ONE array, keeps
# the raw sample blocks device-resident, and runs the fused step over the
# batch in ONE dispatch. Feedback (EKF
# measurement -> channel steering) is applied at batch boundaries; within a
# batch, predictions are propagated from the batch-start fix. The score
# windows (several samples/bins wide beyond the grid span) dwarf the
# sub-sample prediction drift a static-to-dynamic receiver accumulates over
# a fraction of a second, so accuracy is preserved (validated in tests
# against the per-block loop).
# ---------------------------------------------------------------------------

FPK_ROWS = 11  # rc_mid, fi, ri, los_e, los_n, los_u, r0, pos_c, pos_k, vel_c, vel_k
IPK_ROWS = 3   # idx_next, pos_start, vel_start
PK_ROWS = FPK_ROWS + IPK_ROWS + 1  # + start row: ONE upload per batch.
# The int rows ride as float32 (all values < 2^24, exact), so fpk/ipk/start
# travel as a single [N, PK_ROWS, C] upload.


def pack_params(fpk, ipk, start: int) -> np.ndarray:
    """[N,11,C] f64/f32 + [N,3,C] int + scalar start -> [N, 15, C] f32."""
    n, _, c = fpk.shape
    pk = np.empty((n, PK_ROWS, c), np.float32)
    pk[:, :FPK_ROWS] = fpk
    pk[:, FPK_ROWS:FPK_ROWS + IPK_ROWS] = ipk
    pk[:, FPK_ROWS + IPK_ROWS] = np.float32(start)
    return pk


def _unpack_params(pk):
    """-> (fpk [N,11,C] f32, ipk [N,3,C] i32, start i32 scalar)."""
    fpk = pk[:, :FPK_ROWS]
    ipk = pk[:, FPK_ROWS:FPK_ROWS + IPK_ROWS].astype(jnp.int32)
    start = pk[0, FPK_ROWS + IPK_ROWS, 0].astype(jnp.int32)
    return fpk, ipk, start


# Grid points per scan chunk of the block-batched scorer: peak live memory
# is one [N, C, SCORE_CHUNK, W] one-hot tensor. 8192 scored the product
# batch faster than 1024 on an H100 (CHANGES.md).
SCORE_CHUNK = 8192


def _score_chunk(win_mag, los_enu, centers, coefs, r0, o3, o1,
                 interp: str, l_power: int):
    """Score one grid chunk for all blocks: [N, chunk].

    win_mag: [N, C, W]; los_enu: [N, C, 3]; centers/coefs: [N, C];
    r0: [N, C] (position manifold curvature) or None (velocity manifold);
    o3: [chunk, 3]; o1: [chunk].
    """
    u = jnp.einsum("gj,ncj->ncg", o3, los_enu,
                   preferred_element_type=jnp.float32)  # [N,C,chunk]
    if r0 is not None:
        d2 = jnp.sum(o3 * o3, axis=1)
        rng_ = -u + (d2[None, None, :] - u * u) / (2.0 * r0[..., None])
    else:
        rng_ = -u
    idx = centers[..., None] + coefs[..., None] * (rng_ + o1[None, None, :])
    w = win_mag.shape[2]
    if interp == "quadratic":
        # 3-tap form: ONE one-hot compare over [N,C,chunk,W] plus a
        # 3-column dot against shifted windows, instead of materializing
        # the full banded weight tensor (6 selects/element) — the scorer
        # is elementwise-bound on that tensor.
        k0 = jnp.clip(jnp.round(idx), 1.0, w - 2.0)     # [N,C,chunk]
        d = idx - k0
        k = jax.lax.broadcasted_iota(jnp.float32, (1, 1, 1, w), 3)
        zeros = jnp.zeros_like(win_mag[:, :, :1])
        win_taps = jnp.stack([
            jnp.concatenate([zeros, win_mag[:, :, :-1]], axis=2),  # win[k-1]
            win_mag,                                               # win[k]
            jnp.concatenate([win_mag[:, :, 1:], zeros], axis=2),   # win[k+1]
        ], axis=-1)                                     # [N,C,W,3]
        oh = (k0[..., None] == k).astype(jnp.float32)   # [N,C,chunk,W]
        taps = jnp.einsum("ncgw,ncwt->ncgt", oh, win_taps,
                          preferred_element_type=jnp.float32)
        d2_ = d * d
        vals = (0.5 * (d2_ - d) * taps[..., 0]
                + (1.0 - d2_) * taps[..., 1]
                + 0.5 * (d2_ + d) * taps[..., 2])       # [N,C,chunk]
    else:
        wgt = _interp_weights(idx, w, interp)           # [N,C,chunk,W]
        vals = jnp.einsum("ncgw,ncw->ncg", wgt, win_mag,
                          preferred_element_type=jnp.float32)
    if l_power == 1:
        return jnp.sum(vals, axis=1)                    # [N, chunk]
    return jnp.sum(vals ** l_power, axis=1)


def _chunked_grid(off3, off1, chunk, valid=None):
    """Pad + reshape the grid to [K, chunk] scan chunks (+ validity mask)."""
    g = off3.shape[0]
    chunk = min(chunk, g)
    n_chunks = -(-g // chunk)
    pad = n_chunks * chunk - g
    off3_ch = jnp.pad(off3, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)
    off1_ch = jnp.pad(off1, ((0, pad),)).reshape(n_chunks, chunk)
    if valid is None:
        valid = (jnp.arange(n_chunks * chunk) < g).reshape(n_chunks, chunk)
    else:
        valid = jnp.pad(valid, ((0, pad),)).reshape(n_chunks, chunk)
    return off3_ch, off1_ch, valid, chunk


def _constrain_chan(mesh, out: "RealBlockOut", los_enu, fpk):
    """Shard the per-channel correlation outputs over the 'chan' mesh axis
    so the scoring weight tensor is partitioned on BOTH mesh axes (its C
    contraction becomes a psum over 'chan')."""
    if mesh is None or int(mesh.shape.get("chan", 1)) == 1:
        return out, los_enu, fpk
    from jax.sharding import NamedSharding, PartitionSpec as P
    c3 = NamedSharding(mesh, P(None, "chan", None))

    def cst(x, s):
        # explicit replicated stepping stone: sharding propagation can
        # assign a block-axis tiling to the tiny post-correlation tensors,
        # and a direct tiled->tiled reshard on misaligned dims triggers an
        # SPMD involuntary full rematerialization warning; via replicated
        # it is one all-gather + a local slice
        x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P()))
        return jax.lax.with_sharding_constraint(x, s)
    out = RealBlockOut(code_mag=cst(out.code_mag, c3),
                       carr_mag=cst(out.carr_mag, c3),
                       flip_used=cst(out.flip_used,
                                     NamedSharding(mesh, P(None, "chan"))))
    los_enu = cst(los_enu, c3)
    fpk = cst(fpk, NamedSharding(mesh, P(None, None, "chan")))
    return out, los_enu, fpk


def _constrain_replicated(mesh, tree):
    """Gather a (block-sharded) tree to fully replicated on every device.

    Used at the block-shard -> grid-shard transition for tensors that are
    about to be reshaped: GSPMD cannot reshape a tensor whose sharded axis
    splits (e.g. [N]@'grid' -> [g, group_k]) without an "involuntary full
    rematerialization" (spmd_partitioner.cc:652) — the exact collective we
    want, but emitted as a last-resort warning. Requesting replication
    explicitly makes it ONE planned all-gather of the tiny [N, C, W]
    window tensors (a few hundred KB), after which the reshape is free and
    scoring re-shards over 'grid'."""
    if mesh is None:
        return tree
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(x, rep), tree)


def _constrain_block_axis(mesh, tree, axis_ok=True):
    """Shard leading (block) axes over the 'grid' mesh axis.

    The correlation stage has no grid axis, so on a pure-'grid' mesh it
    would otherwise run fully REPLICATED on every device — an Amdahl
    floor that caps strong scaling at small grids. Blocks are
    independent through correlation, so the same devices data-parallel
    over the block axis here, then re-gather the tiny [N, C, W] windows
    (a few hundred KB) for grid-sharded scoring — two cheap collectives
    per dispatch inserted by GSPMD at the constraint boundary."""
    if mesh is None or int(mesh.shape.get("grid", 1)) == 1 or not axis_ok:
        return tree
    from jax.sharding import NamedSharding, PartitionSpec as P

    def cst(x):
        spec = ["grid"] + [None] * (x.ndim - 1)
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(*spec)))

    return jax.tree.map(cst, tree)


def _local_argmax_scan(win_mag, los_enu, centers, coefs, r0, off3, off1,
                       valid, interp: str, l_power: int, chunk: int,
                       block_sum: bool, psum_axis: str | None,
                       psum_group: int = 4, weighted: bool = False):
    """Streaming (max, argmax) over a (local) grid slice.

    Scans grid chunks carrying the running best; tie-break keeps the first
    occurrence, bit-identical to jnp.argmax over the full surface. Peak
    live memory is one [N, C, chunk, W] weight tensor, independent of G —
    what makes reference-cap dense grids (2*75^4 ~ 63M points,
    batchcorrmanifold.h:17) fit. block_sum=True reduces the block axis
    (noncoherent integration) so best/arg are scalars instead of [N].
    psum_axis: mesh axis name carrying a channel shard (the C contraction
    completes with a psum) — used inside shard_map only. psum_group: with
    a psum_axis, score that many chunks per scan step and reduce them in
    ONE collective — per-collective latency otherwise dominates the
    chan-sharded scorer (2 manifolds x G/chunk collectives per batch); the
    scoring math and first-occurrence tie-break are unchanged.
    weighted=True also accumulates sum(score * [o3, o1]) [.., 4] and
    sum(score) [..] over the grid — the score-weighted-mean estimator of
    reference BCM_PosMeas/BCM_VelMeas (batchcorrmanifold.cu:348-784,
    atomicAdd weighted mean), as one extra fused reduction per chunk.
    Returns (best, arg) or (best, arg, wsum4, wtot).
    """
    n = win_mag.shape[0]
    off3_ch, off1_ch, valid_ch, chunk = _chunked_grid(off3, off1, chunk,
                                                      valid)
    m = psum_group if psum_axis is not None else 1
    n_chunks = off3_ch.shape[0]
    if m > 1:
        gpad = (-n_chunks) % m
        off3_ch = jnp.pad(off3_ch, ((0, gpad), (0, 0), (0, 0)))
        off1_ch = jnp.pad(off1_ch, ((0, gpad), (0, 0)))
        valid_ch = jnp.pad(valid_ch, ((0, gpad), (0, 0)))
        n_chunks = n_chunks + gpad
        off3_ch = off3_ch.reshape(n_chunks // m, m, chunk, 3)
        off1_ch = off1_ch.reshape(n_chunks // m, m, chunk)
        valid_ch = valid_ch.reshape(n_chunks // m, m * chunk)
        n_steps = n_chunks // m
    else:
        valid_ch = valid_ch.reshape(n_chunks, chunk)
        n_steps = n_chunks

    def step(carry, xs):
        best, arg, wsum4, wtot = carry
        o3, o1, vmask, k = xs
        if m > 1:
            scores = jnp.concatenate(
                [_score_chunk(win_mag, los_enu, centers, coefs, r0,
                              o3[i], o1[i], interp, l_power)
                 for i in range(m)], axis=-1)           # [N, m*chunk]
            o3f = o3.reshape(m * chunk, 3)
            o1f = o1.reshape(m * chunk)
        else:
            scores = _score_chunk(win_mag, los_enu, centers, coefs, r0,
                                  o3, o1, interp, l_power)  # [N, chunk]
            o3f, o1f = o3, o1
        if psum_axis is not None:
            scores = jax.lax.psum(scores, psum_axis)
        if block_sum:
            scores = jnp.sum(scores, axis=0)            # [m*chunk]
        vm = vmask if block_sum else vmask[None, :]
        if weighted:
            sz = jnp.where(vm, scores, 0.0)
            o4 = jnp.concatenate([o3f, o1f[:, None]], axis=1)  # [k, 4]
            wsum4 = wsum4 + sz @ o4
            wtot = wtot + jnp.sum(sz, axis=-1)
        scores = jnp.where(vm, scores, -jnp.inf)
        cb = jnp.max(scores, axis=-1)
        ca = (jnp.argmax(scores, axis=-1).astype(jnp.int32)
              + k * np.int32(m * chunk))
        take = cb > best
        return (jnp.where(take, cb, best),
                jnp.where(take, ca, arg).astype(jnp.int32),
                wsum4, wtot), None

    shape = () if block_sum else (n,)
    init = (jnp.full(shape, -jnp.inf, jnp.float32),
            jnp.zeros(shape, jnp.int32),
            jnp.zeros(shape + (4,), jnp.float32),
            jnp.zeros(shape, jnp.float32))
    (best, arg, wsum4, wtot), _ = jax.lax.scan(
        step, init,
        (off3_ch, off1_ch, valid_ch, jnp.arange(n_steps, dtype=jnp.int32)))
    if weighted:
        return best, arg, wsum4, wtot
    return best, arg


def _score_axis_sharded(win_mag, los_enu, centers, coefs, r0, off3, off1,
                        interp: str, l_power: int, chunk: int, mesh,
                        block_sum: bool, weighted: bool = False):
    """shard_map wrapper around _local_argmax_scan (SURVEY §2.3 P3/P7).

    Each device streams its own contiguous grid slice with ZERO per-chunk
    communication over 'grid'; channels shard over 'chan' (the C
    contraction becomes one small psum per chunk); the only 'grid'
    collective is the final all-gather of per-device (best, arg) pairs —
    a few bytes per device (+ one psum of the weighted sums when
    weighted). Tie-break: jnp.argmax over the [nd, ...]
    gathered bests picks the lowest device index, which holds the earliest
    grid slice — identical to the single-device first-occurrence rule.
    """
    from jax.sharding import PartitionSpec as P

    nd = int(mesh.shape["grid"])
    nc = int(mesh.shape.get("chan", 1))
    g = off3.shape[0]
    local_g = -(-g // nd)
    pad = local_g * nd - g
    off3p = jnp.pad(off3, ((0, pad), (0, 0)))
    off1p = jnp.pad(off1, ((0, pad),))
    validp = jnp.arange(local_g * nd) < g

    has_r0 = r0 is not None
    r0_in = r0 if has_r0 else jnp.zeros_like(centers)
    chan_split = nc > 1 and centers.shape[-1] % nc == 0
    cspec3 = P(None, "chan", None) if chan_split else P()
    cspec2 = P(None, "chan") if chan_split else P()

    def local(win, los, cen, coe, r0l, o3, o1, val):
        res = _local_argmax_scan(
            win, los, cen, coe, r0l if has_r0 else None, o3, o1, val,
            interp, l_power, chunk, block_sum,
            psum_axis="chan" if chan_split else None, weighted=weighted)
        best, arg = res[0], res[1]
        k = jax.lax.axis_index("grid").astype(jnp.int32)
        arg = arg + k * np.int32(local_g)
        bests = jax.lax.all_gather(best, "grid")        # [nd, ...]
        args = jax.lax.all_gather(arg, "grid")
        sel = jnp.argmax(bests, axis=0)
        out = (jnp.take_along_axis(bests, sel[None], 0)[0],
               jnp.take_along_axis(args, sel[None], 0)[0])
        if weighted:
            out = out + (jax.lax.psum(res[2], "grid"),
                         jax.lax.psum(res[3], "grid"))
        return out

    out_specs = (P(), P(), P(), P()) if weighted else (P(), P())
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(cspec3, cspec3, cspec2, cspec2, cspec2,
                  P("grid", None), P("grid"), P("grid")),
        out_specs=out_specs, check_vma=False,
    )(win_mag, los_enu, centers, coefs, r0_in, off3p, off1p, validp)


def _score_axis_argmax(win_mag, los_enu, centers, coefs, r0, off3, off1,
                       interp: str, l_power: int, chunk: int | None = None,
                       mesh=None, weighted: bool = False):
    """Streaming (max, argmax) over the grid without materializing [N, G].

    Returns (best [N] f32, arg [N] i32) (+ (wsum4 [N,4], wtot [N]) when
    weighted). With a mesh, each device scans its own grid slice (see
    _score_axis_sharded). chunk=None means SCORE_CHUNK."""
    chunk = chunk or SCORE_CHUNK
    if mesh is not None and int(mesh.shape["grid"]) > 1:
        return _score_axis_sharded(win_mag, los_enu, centers, coefs, r0,
                                   off3, off1, interp, l_power, chunk,
                                   mesh, block_sum=False, weighted=weighted)
    return _local_argmax_scan(win_mag, los_enu, centers, coefs, r0,
                              off3, off1, None, interp, l_power, chunk,
                              block_sum=False, psum_axis=None,
                              weighted=weighted)


def _score_axis_accumulate(win_mag, los_enu, centers, coefs, r0, off3, off1,
                           interp: str, l_power: int,
                           chunk: int | None = None, mesh=None,
                           weighted: bool = False):
    """Noncoherent block-integrated (max, argmax): sum over blocks then the
    streaming best, without materializing [N, G] or [G].

    Streams grid chunks (peak memory independent of G) and reduces the
    block axis inside each chunk. Returns (best f32, arg i32) scalars
    (+ (wsum4 [4], wtot) when weighted). chunk=None means SCORE_CHUNK.
    """
    chunk = chunk or SCORE_CHUNK
    if mesh is not None and int(mesh.shape["grid"]) > 1:
        return _score_axis_sharded(win_mag, los_enu, centers, coefs, r0,
                                   off3, off1, interp, l_power, chunk,
                                   mesh, block_sum=True, weighted=weighted)
    return _local_argmax_scan(win_mag, los_enu, centers, coefs, r0,
                              off3, off1, None, interp, l_power, chunk,
                              block_sum=True, psum_axis=None,
                              weighted=weighted)


@functools.partial(jax.jit, static_argnames=("carr_fftpts", "period",
                                             "n_periods", "n_blocks",
                                             "l_power", "interp",
                                             "return_windows", "mesh",
                                             "code_win", "carr_win",
                                             "group_k", "use_argmax"))
def dpe_batch_blocks(raw_all_i16, pk, chips, base0, time_idc,
                     d_enu, dt_m, dv_enu, dtdot,
                     carr_fftpts: int, period: int, n_periods: int,
                     n_blocks: int, l_power: int = 1,
                     interp: str = "quadratic",
                     return_windows: bool = True, mesh=None,
                     code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                     group_k: int = 1, use_argmax: bool = True):
    """Block-batched fused DPE: vmap over blocks instead of a device loop.

    pk: [N, PK_ROWS, C] float32 packed per-block parameters + start index
    (pack_params) — one upload per batch. Every op processes all n_blocks
    at once: a per-block device loop (lax.map) dispatches ~10^2 kernels
    per block, which dominates runtime on accelerators with per-kernel
    dispatch overhead; the batched form launches each kernel once for the
    whole batch. Returns one packed float32 row per block (argmaxes,
    peaks, flips[, score windows]) so the host needs a single fetch.

    return_windows=False drops the per-channel score windows from the
    packed row ([N, 4+C] instead of [N, 4+C+C*(CODE_WIN+CARR_WIN)]) —
    they are only consumed by the Newton sub-grid refinement, and on a
    latency-bound host link the smaller fetch matters.

    mesh: optional jax.sharding.Mesh with 'grid' (and optionally 'chan')
    axes — manifold scoring shards over grid points, correlation windows
    over channels; results replicate. The multi-device product path
    (SURVEY §2.3 P7; reference gap at architecture.txt:92-101).

    group_k > 1: coherent grouping — all n_blocks are still correlated in
    one vmapped pass, but each group of group_k consecutive blocks is
    coherently summed (complex windows, data-aided nav-bit alignment —
    _coherent_sum) before manifold scoring, returning n_blocks/group_k
    rows. Manifold scoring is the memory-bound majority of the dispatch
    (CHANGES.md: ~23x the correlation per block on an H100), so
    scoring once per K blocks instead of per block is the throughput
    lever past the per-block scorer's traffic floor; accuracy at
    practical C/N0 matches per-block fixes (see dpe_scan_integrate:
    coherent buys COST, not dB). Each group's row is referenced to its
    LAST block's prediction; flips reported are the last block's.
    """
    fpk, ipk, start = _unpack_params(pk)
    if group_k > 1:
        if n_blocks % group_k:
            raise ValueError(f"n_blocks {n_blocks} % group_k {group_k} != 0")
        g = n_blocks // group_k
        outc = _batch_correlate(raw_all_i16, start, fpk, ipk, chips, base0,
                                time_idc, carr_fftpts, period, n_periods,
                                n_blocks, code_win, carr_win,
                                complex_out=True, mesh=mesh)
        # gather the tiny complex windows to replicated BEFORE the grouped
        # reshape: a sharded [N]@grid -> [g, group_k] reshape forces an SPMD
        # involuntary full rematerialization; replicated,
        # the reshape is free and the coherent sum is negligible compute
        outc = _constrain_replicated(mesh, outc)
        outg = jax.vmap(_coherent_sum)(RealBlockOutC(
            *(x.reshape((g, group_k) + x.shape[1:]) for x in outc)))
        out = RealBlockOut(code_mag=outg.code_mag[:, 0],
                           carr_mag=outg.carr_mag[:, 0],
                           flip_used=outg.flip_used[:, -1])    # [G, C, W]
        fpk = fpk[group_k - 1::group_k]                        # [G, ...]
    else:
        out = _batch_correlate(raw_all_i16, start, fpk, ipk, chips, base0,
                               time_idc, carr_fftpts, period, n_periods,
                               n_blocks, code_win, carr_win, mesh=mesh)
    los_enu = jnp.transpose(fpk[:, 3:6], (0, 2, 1))     # [N, C, 3]
    out, los_enu, fpk = _constrain_chan(mesh, out, los_enu, fpk)
    weighted = not use_argmax
    pres = _score_axis_argmax(out.code_mag, los_enu, fpk[:, 7],
                              fpk[:, 8], fpk[:, 6], d_enu, dt_m,
                              interp, l_power, mesh=mesh,
                              weighted=weighted)        # [N], [N][, ...]
    vres = _score_axis_argmax(out.carr_mag, los_enu, fpk[:, 9],
                              fpk[:, 10], None, dv_enu, dtdot,
                              interp, l_power, mesh=mesh, weighted=weighted)
    pb, pa = pres[0], pres[1]
    vb, va = vres[0], vres[1]
    wmean = _weighted_cols(pres, vres) if weighted else None
    return _pack_rows(out, pa, pb, va, vb, return_windows, wmean=wmean)


def _batch_correlate(raw_all_i16, start, fpk, ipk, chips, base0, time_idc,
                     carr_fftpts: int, period: int, n_periods: int,
                     n_blocks: int, code_win: int = CODE_WIN,
                     carr_win: int = CARR_WIN, complex_out: bool = False,
                     mesh=None):
    """Slice n_blocks from the device capture and correlate them (vmapped).

    With a mesh, the block axis shards over 'grid' (and channels over
    'chan') — blocks are independent through correlation, so the grid
    devices data-parallel here instead of replicating the stage
    (_constrain_block_axis)."""
    raw = jax.lax.dynamic_slice(
        raw_all_i16, (start, 0, 0),
        (n_blocks,) + tuple(raw_all_i16.shape[1:]))     # [N, S, 2]
    raw_re = raw[..., 0].astype(jnp.float32)
    raw_im = raw[..., 1].astype(jnp.float32)
    raw_re, raw_im, fpk, ipk = _constrain_block_axis(
        mesh, (raw_re, raw_im, fpk, ipk))
    out = jax.vmap(
        functools.partial(windowed_correlate, code_win=code_win,
                          carr_win=carr_win, complex_out=complex_out),
        in_axes=(0, 0, None, None, 0, 0, 0, 0, None, 0, 0, None, None, None)
    )(raw_re, raw_im, chips, base0, fpk[:, 0], ipk[:, 0], fpk[:, 1],
      fpk[:, 2], time_idc, ipk[:, 1], ipk[:, 2],
      carr_fftpts, period, n_periods)
    return _constrain_block_axis(mesh, out)


def _coherent_sum(outc: RealBlockOutC) -> RealBlockOut:
    """Sum complex windows over the block axis with data-aided nav-bit
    alignment, then take magnitudes ([1, C, W] outputs).

    The 50 bps data bits flip whole 20 ms blocks in sign; no decoded bit
    stream is needed: each block is aligned against the RUNNING coherent
    sum (decision-directed — the reference grows ~sqrt(k) in SNR, so the
    alignment is far more robust at low C/N0 than consecutive-pair
    differential signs, where one early error flips the whole tail).
    The decision metric uses only the central taps of each window (the
    prediction puts the true peak at the window center, so the center tap
    is the matched statistic; summing the full window would add W noise
    bins against ~2 signal bins and ruin the decision at low C/N0), from
    both the code and carrier windows. Residual carrier rotation between
    blocks is the steered-prediction error (~mHz x 20 ms, negligible over
    practical spans)."""
    mc = outc.code_re.shape[2] // 2
    mv = outc.carr_re.shape[2] // 2
    sl_c = slice(mc - 1, mc + 2)
    sl_v = slice(mv - 1, mv + 2)

    def step(carry, xs):
        a_cre, a_cim, a_vre, a_vim = carry
        cre, cim, vre, vim = xs                              # [C, W]
        dot = (jnp.sum(cre[:, sl_c] * a_cre[:, sl_c]
                       + cim[:, sl_c] * a_cim[:, sl_c], axis=1)
               + jnp.sum(vre[:, sl_v] * a_vre[:, sl_v]
                         + vim[:, sl_v] * a_vim[:, sl_v], axis=1))  # [C]
        s = jnp.where(dot >= 0.0, 1.0, -1.0)[:, None]        # first: +1
        return (a_cre + s * cre, a_cim + s * cim,
                a_vre + s * vre, a_vim + s * vim), None

    zc = jnp.zeros_like(outc.code_re[0])
    zv = jnp.zeros_like(outc.carr_re[0])
    (code_re, code_im, carr_re, carr_im), _ = jax.lax.scan(
        step, (zc, zc, zv, zv),
        (outc.code_re, outc.code_im, outc.carr_re, outc.carr_im))
    return RealBlockOut(
        code_mag=jnp.sqrt(code_re ** 2 + code_im ** 2)[None],
        carr_mag=jnp.sqrt(carr_re ** 2 + carr_im ** 2)[None],
        flip_used=outc.flip_used)


WMEAN_COLS = 8  # pos weighted-mean offsets [4] + vel weighted-mean [4]


def _weighted_cols(pres, vres):
    """[..., 8] score-weighted-mean offsets from the (best, arg, wsum4,
    wtot) results of a weighted scoring pass: sum(w*offset)/sum(w) per
    manifold (reference BCM_*Meas atomicAdd estimator,
    batchcorrmanifold.cu:348-784; PyGNSS receiver.py:254-320)."""
    pmean = pres[2] / jnp.maximum(pres[3][..., None], 1e-30)
    vmean = vres[2] / jnp.maximum(vres[3][..., None], 1e-30)
    return jnp.concatenate([pmean, vmean], axis=-1)


def _pack_rows(out: RealBlockOut, pa, pb, va, vb, return_windows: bool,
               wmean=None):
    """One float32 row per block so the host needs a single fetch.

    Argmax indices are BITCAST into the f32 lanes (unpack_row_indices on
    the host), not value-converted: float32 only holds integers exactly
    to 2^24 = 16.7M and a dense 75^4 manifold has 31.6M points — a cast
    would silently round the winning index.

    Layout: [head 4][flips C][wmean 8, only when weighted][windows]."""
    n = pa.shape[0]
    head = jnp.stack([jax.lax.bitcast_convert_type(pa.astype(jnp.int32),
                                                   jnp.float32), pb,
                      jax.lax.bitcast_convert_type(va.astype(jnp.int32),
                                                   jnp.float32), vb],
                     axis=1)                                  # [N, 4]
    parts = [head, out.flip_used.astype(jnp.float32)]
    if wmean is not None:
        parts.append(wmean)                                   # [N, 8]
    if return_windows:
        parts += [out.code_mag.reshape(n, -1), out.carr_mag.reshape(n, -1)]
    return jnp.concatenate(parts, axis=1)


def unpack_row_indices(rows: "np.ndarray") -> tuple:
    """Host-side decode of the bitcast argmax indices in packed rows:
    (pos_idx [N] int, vel_idx [N] int)."""
    r = np.ascontiguousarray(rows[:, 0], dtype=np.float32)
    pas = r.view(np.int32).astype(np.int64)
    r = np.ascontiguousarray(rows[:, 2], dtype=np.float32)
    vas = r.view(np.int32).astype(np.int64)
    return pas, vas


@functools.partial(jax.jit, static_argnames=("carr_fftpts", "period",
                                             "n_periods", "n_blocks",
                                             "l_power", "interp", "mesh",
                                             "code_win", "carr_win",
                                             "coherent", "return_windows",
                                             "use_argmax"))
def dpe_scan_integrate(raw_all_i16, pk, chips, base0, time_idc,
                       d_enu, dt_m, dv_enu, dtdot,
                       carr_fftpts: int, period: int, n_periods: int,
                       n_blocks: int, l_power: int = 1,
                       interp: str = "quadratic", mesh=None,
                       code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                       coherent: bool = False,
                       return_windows: bool = False,
                       use_argmax: bool = True):
    """Multi-block score integration in one dispatch.

    Noncoherent (default): accumulates the position/velocity score
    surfaces over n_blocks consecutive blocks (predictions frozen at the
    batch start, so a given grid candidate is the same absolute state in
    every block) and returns one argmax per batch: sqrt(N) score-noise
    reduction at 1/N fix rate. A capability beyond the reference, enabled
    by the windowed engine — accumulating 2x25^4 scores per block is free
    on device, ruinous to fetch. Streaming over grid chunks: dense grids
    integrate too.

    Coherent: sums the COMPLEX correlation windows over the batch (with
    data-aided nav-bit alignment, _coherent_sum) before the magnitude.
    Accuracy matches the noncoherent path at practical C/N0 (at 20 ms
    blocks the per-block amplitude SNR stays >~2 down to ~22 dB-Hz, so
    noncoherent squaring loss is ~1 dB — measured: oracle-bit coherent
    does NOT beat noncoherent above that); what coherent buys is COST:
    the manifold is scored once per batch instead of once per block —
    N x less scoring traffic, the difference between offline and
    real-time dense-grid (75^4-scale) integration. Geometry is the last
    block's (measurements are referenced to its prediction, as in the
    noncoherent path).
    """
    fpk, ipk, start = _unpack_params(pk)
    if coherent:
        outc = _batch_correlate(raw_all_i16, start, fpk, ipk, chips, base0,
                                time_idc, carr_fftpts, period, n_periods,
                                n_blocks, code_win, carr_win,
                                complex_out=True, mesh=mesh)
        out = _coherent_sum(outc)
        fpk_s = fpk[-1:]
    else:
        out = _batch_correlate(raw_all_i16, start, fpk, ipk, chips, base0,
                               time_idc, carr_fftpts, period, n_periods,
                               n_blocks, code_win, carr_win, mesh=mesh)
        fpk_s = fpk
    los_enu = jnp.transpose(fpk_s[:, 3:6], (0, 2, 1))
    flips = out.flip_used
    out, los_enu, fpk_s = _constrain_chan(mesh, out, los_enu, fpk_s)
    weighted = not use_argmax
    pres = _score_axis_accumulate(
        out.code_mag, los_enu, fpk_s[:, 7], fpk_s[:, 8], fpk_s[:, 6],
        d_enu, dt_m, interp, l_power, mesh=mesh, weighted=weighted)
    vres = _score_axis_accumulate(
        out.carr_mag, los_enu, fpk_s[:, 9], fpk_s[:, 10], None,
        dv_enu, dtdot, interp, l_power, mesh=mesh, weighted=weighted)
    pb, pa = pres[0], pres[1]
    vb, va = vres[0], vres[1]
    head = jnp.stack([jax.lax.bitcast_convert_type(pa.astype(jnp.int32),
                                                   jnp.float32), pb,
                      jax.lax.bitcast_convert_type(va.astype(jnp.int32),
                                                   jnp.float32), vb])
    if weighted:
        # head grows to 12: [pa, pb, va, vb, wmean(8)] — weighted-mean
        # offsets of the INTEGRATED surfaces
        head = jnp.concatenate([head, _weighted_cols(pres, vres)])
    if return_windows:
        # the integrated window magnitudes, interpretable with the LAST
        # block's params (the per-block preps re-anchor the window centers,
        # so every block's window puts its peak at the same in-window
        # offset to sub-tap accuracy). Coherent: |complex sum| ([1, C, W]
        # already). Noncoherent: sum of per-block magnitudes — the same
        # surface the argmax above integrates, collapsed onto the common
        # window frame. Consumers: the host-side Newton polish and the
        # multi-epoch survey solve (weak-signal mode collects NONCOHERENT
        # batch windows, since data-aided bit alignment breaks below
        # ~22 dB-Hz while magnitude integration never needs the bits).
        return (head, flips, jnp.sum(out.code_mag, axis=0),
                jnp.sum(out.carr_mag, axis=0))
    return (head, flips)


@functools.partial(jax.jit, static_argnames=("interp", "l_power", "has_r0",
                                             "mesh", "chunk"))
def score_joint_argmax(win_mag, los_enu, centers, coefs, r0, off3, off1,
                       interp: str = "quadratic", l_power: int = 1,
                       has_r0: bool = True, mesh=None,
                       chunk: int | None = None):
    """Multi-epoch joint (max, argmax): one candidate state scored against
    MANY epochs' integrated windows, each with its own geometry.

    The epoch axis reuses the scorer's block axis: win_mag [B, C, W],
    los_enu [B, C, 3], centers/coefs/r0 [B, C] — per-epoch satellite
    LOS/range geometry (satellites move over the pass, so late epochs see
    rotated manifolds: genuine geometric diversity, not just noise
    averaging). off3 [G, 3] / off1 [G] are displacements from ONE common
    reference state; the caller folds each epoch's prediction-to-reference
    offset (including a linear clock-drift model) into that epoch's
    `centers`. Returns scalar (best f32, arg i32).

    This is the estimator the reference's per-block fetch architecture
    cannot express (batchcorrmanifold.cu scores and discards one block's
    surface per Update); with a mesh it shards over 'grid'/'chan' like
    every other scoring path.
    """
    return _score_axis_accumulate(win_mag, los_enu, centers, coefs,
                                  r0 if has_r0 else None, off3, off1,
                                  interp, l_power, chunk=chunk, mesh=mesh)
