"""All-real acquisition: circulant-matmul code search + windowed DFT
fine frequency.

The FFT formulation (ops.acquisition) needs complex FFTs; this engine
reaches the same result with float32 matmuls:

- the C/A code period is exactly `T_CA*fs` samples, so the Doppler-wiped
  signal folds per period and the circular correlation over all code lags is
  `folded @ Circulant(code)^T` — a [D, P0] x [P0, P0] matmul per PRN. The
  circulant is built on device from the doubled one-period replica with
  vmapped dynamic slices (no gather, no host upload).
- coherent mode folds all periods into one row per Doppler; noncoherent
  mode folds per millisecond and sums magnitudes after the matmul.
- fine frequency evaluates only the needed band of the zero-padded carrier
  spectrum via the two-stage windowed DFT from ops.dpe_real.

Parity: reference correlator.coarse_acquisition / fine_frequency_acquisition
(correlator.py:53-133) and BCS acquisition behavior.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import F_CA, L_CA
from .acquisition import DOPPLER_COHERENT, AcqResult
from .dpe_real import _dft_twiddles


def _circulant(period_code: jax.Array) -> jax.Array:
    """[P0, P0] matrix M[m, q] = code[(q - m) mod P0] (rows = lags)."""
    p0 = period_code.shape[0]
    doubled = jnp.concatenate([period_code, period_code])
    starts = jnp.mod(p0 - jnp.arange(p0), p0)

    def row(st):
        return jax.lax.dynamic_slice(doubled, (st,), (p0,))

    return jax.vmap(row)(starts)


@functools.partial(jax.jit, static_argnames=("period", "coherent", "n_coh"))
def coarse_search_real(raw_re, raw_im, period_codes, dopplers, time_idc,
                       period: int, coherent: bool = True,
                       n_coh: int | None = None):
    """Coarse Doppler x code search, all-real.

    raw_re/raw_im: [S]; period_codes: [P, period] one-period +/-1 replicas;
    dopplers: [D]. Returns result [P, D, period] magnitudes.

    n_coh: coherent fold length in code periods (ms). The search runs
    K = n_periods/n_coh segments: each folds n_coh periods coherently,
    magnitudes sum across segments (noncoherent). This is the standard
    deep-acquisition ladder — coherent gain bounded by the Doppler bin
    width and the unknown 20 ms bit boundaries, noncoherent gain on top
    for as long a capture as provided. n_coh=None keeps the legacy modes:
    coherent=True folds everything (one segment), False is per-ms
    noncoherent (n_coh=1).
    """
    s = raw_re.shape[0]
    n_per = s // period
    if n_coh is None:
        n_coh = n_per if coherent else 1
    assert n_per % n_coh == 0, (n_per, n_coh)
    k = n_per // n_coh                                  # segments

    ang = 2.0 * jnp.pi * dopplers[:, None] * time_idc[None, :]
    wc, ws = jnp.cos(ang), jnp.sin(ang)
    bb_re = raw_re[None, :] * wc + raw_im[None, :] * ws       # [D, S]
    bb_im = raw_im[None, :] * wc - raw_re[None, :] * ws

    f_re = jnp.sum(bb_re.reshape(-1, k, n_coh, period),
                   axis=2).reshape(-1, period)          # [D*K, P0]
    f_im = jnp.sum(bb_im.reshape(-1, k, n_coh, period),
                   axis=2).reshape(-1, period)

    def per_prn(code):
        m = _circulant(code)                            # [P0, P0]
        c_re = jnp.dot(f_re, m.T, preferred_element_type=jnp.float32)
        c_im = jnp.dot(f_im, m.T, preferred_element_type=jnp.float32)
        mag = jnp.sqrt(c_re * c_re + c_im * c_im)
        if k > 1:
            mag = jnp.sum(mag.reshape(-1, k, period), axis=1)
        return mag                                      # [D, P0]

    return jax.vmap(per_prn)(period_codes)              # [P, D, P0]


@functools.partial(jax.jit, static_argnames=("carr_fftpts", "n_bins"))
def fine_freq_real(raw_re, raw_im, repl, time_idc, f_lo_bin,
                   carr_fftpts: int, n_bins: int):
    """Windowed-DFT carrier search after code wipeoff, all-real.

    repl: [S] +/-1 replica at the coarse code phase; evaluates n_bins bins of
    the fftshifted zero-padded spectrum starting at f_lo_bin.
    Returns (mag [n_bins], re [n_bins], im [n_bins]).
    """
    s = raw_re.shape[0]
    mean_re = jnp.mean(raw_re)
    mean_im = jnp.mean(raw_im)
    y_re = (raw_re - mean_re) * repl
    y_im = (raw_im - mean_im) * repl

    s0_n = 256
    s1_n = -(-s // s0_n)
    pad = s1_n * s0_n - s
    y_re_p = jnp.pad(y_re, (0, pad)).reshape(1, s1_n, s0_n)
    y_im_p = jnp.pad(y_im, (0, pad)).reshape(1, s1_n, s0_n)

    # reuse the dpe_real twiddle builder with a [1] channel and a custom
    # window width via chunking over CARR_WIN-sized pieces
    from .dpe_real import CARR_WIN
    n_chunks = -(-n_bins // CARR_WIN)
    mags, res, ims = [], [], []
    for k in range(n_chunks):
        start = f_lo_bin + k * CARR_WIN
        a_cos, a_sin, b_cos, b_sin = _dft_twiddles(
            jnp.asarray([start]), carr_fftpts, s1_n, s0_n, CARR_WIN)
        z_re = (jnp.einsum("cws,cst->cwt", a_cos, y_re_p)
                + jnp.einsum("cws,cst->cwt", a_sin, y_im_p))
        z_im = (jnp.einsum("cws,cst->cwt", a_cos, y_im_p)
                - jnp.einsum("cws,cst->cwt", a_sin, y_re_p))
        x_re = jnp.sum(z_re * b_cos + z_im * b_sin, axis=2)[0]
        x_im = jnp.sum(z_im * b_cos - z_re * b_sin, axis=2)[0]
        mags.append(jnp.sqrt(x_re * x_re + x_im * x_im))
        res.append(x_re)
        ims.append(x_im)
    mag = jnp.concatenate(mags)[:n_bins]
    return mag, jnp.concatenate(res)[:n_bins], jnp.concatenate(ims)[:n_bins]


def acquire_real(samples: np.ndarray, prns, fs: float, fcaid: float,
                 dopplers: np.ndarray | None = None, coherent: bool = True,
                 threshold: float = 2.0,
                 n_coh_ms: int | None = None) -> list[AcqResult]:
    """Full acquisition via the real-arithmetic engine.

    n_coh_ms enables deep (weak-signal) acquisition: n_coh_ms-long
    coherent folds, magnitudes summed noncoherently over however many
    segments the capture holds. Pass a long capture (e.g. 100-500 ms) to
    acquire below the nominal ~30 dB-Hz floor of the 10 ms best-of search
    (reference correlator.py:53-103 has no deep mode). The Doppler grid
    defaults to half-bin spacing for the chosen coherent length
    (1/(2*T_coh)); the fine-frequency stage runs on the first segment
    only (a coherent DFT across nav-bit boundaries would self-cancel)."""
    from ..libgnss.cacode import ca_table

    samples = np.asarray(samples)
    period = int(round(fs * 1e-3))
    if n_coh_ms is not None:
        n_seg = samples.shape[0] // (n_coh_ms * period)
        assert n_seg >= 1, "capture shorter than one coherent segment"
        samples = samples[:n_seg * n_coh_ms * period]
        if dopplers is None:
            step = 500.0 / n_coh_ms            # half-bin for T_coh
            n_side = int(np.ceil(6000.0 / step))
            dopplers = np.arange(-n_side, n_side + 1) * step
    s = samples.shape[0]
    if dopplers is None:
        dopplers = DOPPLER_COHERENT
    t = np.arange(s) / fs

    tab = ca_table(prns)
    pidx = np.mod(np.floor(np.arange(period) / fs * F_CA), L_CA).astype(int)
    period_codes = tab[:, pidx].astype(np.float32)          # [P, P0]

    raw_re = jnp.asarray(np.ascontiguousarray(samples.real.astype(np.float32)))
    raw_im = jnp.asarray(np.ascontiguousarray(samples.imag.astype(np.float32)))
    t32 = jnp.asarray(t.astype(np.float32))

    result = coarse_search_real(raw_re, raw_im, jnp.asarray(period_codes),
                                jnp.asarray(dopplers.astype(np.float32)),
                                t32, period, coherent,
                                n_coh=(None if n_coh_ms is None
                                       else int(n_coh_ms)))
    result = np.asarray(result)                             # [P, D, P0]

    # fine-frequency window: the whole capture, except in deep mode where
    # a coherent DFT across bit boundaries would self-cancel — use the
    # first coherent segment
    s_fine = s if n_coh_ms is None else n_coh_ms * period
    raw_re_f, raw_im_f, t32_f = raw_re[:s_fine], raw_im[:s_fine], t32[:s_fine]
    carr_fftpts = 8 * (1 << s_fine.bit_length())
    bin_hz = fs / carr_fftpts
    f_lo = int(np.floor(np.min(dopplers) / bin_hz)) + carr_fftpts // 2
    n_bins = int(np.ceil((np.max(dopplers) - np.min(dopplers)) / bin_hz)) + 2

    out = []
    mask_hw = int(np.ceil(fs / F_CA))
    code_idc_period = np.arange(period) / fs * F_CA
    for i, prn in enumerate(prns):
        r = result[i]
        max_percode = r.max(axis=0)
        code_idx = int(np.argmax(max_percode))
        dopp_idx = int(np.argmax(r[:, code_idx]))
        peak = max_percode[code_idx]
        pos = np.arange(period)
        dist = np.minimum(np.abs(pos - code_idx),
                          period - np.abs(pos - code_idx))
        masked = np.where(dist <= mask_hw, 0.0, max_percode)
        cppr = peak / masked.max()
        srt = np.sort(masked)
        lo_i, hi_i = int(period * 0.05), int(period * 0.95)
        cppm = peak / srt[lo_i:hi_i].mean()
        if n_coh_ms is not None:
            # deep mode: K-fold noncoherent summation drives the floor's
            # relative fluctuation down ~sqrt(K), so the peak/mean ratio
            # compresses toward 1 even for a clearly detected satellite —
            # detect on the deviation-normalized peak instead (measured:
            # present ~21 sigma vs absent ~4.5 sigma at 27 dB-Hz / 200 ms)
            floor = max_percode[dist > mask_hw]
            z = (peak - floor.mean()) / max(floor.std(), 1e-12)
            deep_found = bool(z > 8.0)

        rc = L_CA - code_idc_period[code_idx]
        fi = float(dopplers[dopp_idx])
        fc = F_CA + fcaid * fi

        repl_idx = np.mod(np.floor(t[:s_fine] * fc + rc), L_CA).astype(int)
        repl = jnp.asarray(tab[i][repl_idx].astype(np.float32))
        mag, x_re, x_im = fine_freq_real(raw_re_f, raw_im_f, repl, t32_f,
                                         f_lo, carr_fftpts, n_bins)
        mag = np.asarray(mag)
        j = int(np.argmax(mag))
        fi = (f_lo + j - carr_fftpts // 2) * bin_hz
        fc = F_CA + fcaid * fi
        ri = float(np.arctan2(np.asarray(x_im)[j], np.asarray(x_re)[j])
                   / (2.0 * np.pi))
        out.append(AcqResult(prn=int(prn),
                             found=(deep_found if n_coh_ms is not None
                                    else bool(cppm > threshold)),
                             rc=float(rc), ri=ri, fc=float(fc), fi=float(fi),
                             cppr=float(cppr), cppm=float(cppm)))
    return out
