"""Scalar tracking engine: batched E/P/L correlation + DLL/PLL loops.

One jitted `lax.scan` advances all channels through a chunk of 1 ms windows.
The per-step work (carrier wipeoff, three code-phase gathers, segmented
correlation sums, discriminators, loop filters, lock/SNR) is vectorized over
channels; the sequential dependence lives only in the tiny per-channel carry.

Precision design (device float32): phases are carried as residuals —
`dfc = fc - F_CA` so the per-step code-phase update
`rc' = mod(rc + fc*T, L_CA) = mod(rc + dfc*T, L_CA)` never forms the
1023-chip full-rate term, keeping accumulated f32 rounding ~1e-3 chip over
a 36 s run. Carrier phase similarly accumulates `fi*T` (a few cycles).

Parity: reference pygnss/pythonreceiver/scalar/correlator.py:135-283
(segmented E/P/L with polarity resolution and the p_a carry),
channel.py:104-273 (update sequencing), discriminator.py:25-54,
loopfilter.py:89-104, lockdetector.py:64-101, snrmeter.py:42-61.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import F_CA, L_CA

T_MS = 1e-3
SNR_N = 20            # running-average window (reference channel.py:62)
LOCK_K = 1.5
LOCK_LPF = 0.0247
LOCK_LOSS_TH = 50
LOCK_LOCK_TH = 240

# lax.scan unroll of the 1 ms tracking loop: 8 ran a 2000-step chunk
# faster than 1 on an H100 (CHANGES.md); trajectories agree to f32
# reassociation (tests/test_tracking.py::test_track_chunk_unroll_invariant)
SCAN_UNROLL = 8

# default noise bandwidths (reference channel.py:57-58)
BN_CODE_DEFAULT = 3.0      # Hz
BN_CARR_DEFAULT = 40.0     # Hz


class LoopConfig(NamedTuple):
    """Static loop-filter configuration (hashable -> usable as a jit
    static argument; changing it recompiles the scan, which is the right
    trade for scalars that never vary within a run).

    Critically damped constants per reference loopfilter.py:28-72:
    order 2: w0 = Bn/0.53,  Kv = w0^2,    Kp = 1.414*w0
    order 3: w0 = Bn/0.7845, Ka = w0^3, Kv = 1.1*w0^2, Kp = 2.4*w0
    FLL-assist bandwidths (bn_freq): order 2 w0f = Bnf/0.25, Kvf = w0f;
    order 3 w0f = Bnf/0.53, Kaf = w0f^2, Kvf = 1.414*w0f.
    """
    order: int = 2            # 2 or 3
    bn_code: float = BN_CODE_DEFAULT
    bn_carr: float = BN_CARR_DEFAULT
    bn_carr_freq: float = 0.0  # FLL-assist bandwidth (vector/FLL paths)
    boxcar: bool = False       # boxcar instead of bilinear integrators


def _loop_coeffs(order: int, bn: float, bn_f: float):
    """(Kap, Kvp, Kpp, Kaf, Kvf) for one loop (reference loopfilter.py:37-62)."""
    if order == 2:
        w0p = bn / 0.53
        w0f = bn_f / 0.25
        return 0.0, w0p ** 2, 1.414 * w0p, 0.0, w0f
    if order == 3:
        w0p = bn / 0.7845
        w0f = bn_f / 0.53
        return w0p ** 3, 1.1 * w0p ** 2, 2.4 * w0p, w0f ** 2, 1.414 * w0f
    raise ValueError(f"unsupported loop-filter order {order}")


class TrackState(NamedTuple):
    """Per-channel tracking carry (all arrays shaped [C])."""
    rc: jax.Array        # code phase [chips]
    dfc: jax.Array       # fc - F_CA [chips/s]
    ri: jax.Array        # carrier phase [cycles]
    fi: jax.Array        # carrier Doppler [Hz]
    dfc_bias: jax.Array  # fc_bias (loop-filter operating point)
    fi_bias: jax.Array
    cp: jax.Array        # completed code periods (int32)
    p_a_re: jax.Array    # carried partial prompt correlation (re/im)
    p_a_im: jax.Array
    lf_code_h: jax.Array   # velocity-integrator accumulators
    lf_carr_h: jax.Array
    lf_code_h2: jax.Array  # acceleration integrators (3rd-order loops)
    lf_carr_h2: jax.Array
    lock_i: jax.Array    # lock detector LPF states
    lock_q: jax.Array
    losscount: jax.Array
    lockcount: jax.Array
    lock: jax.Array
    snr_z: jax.Array     # [C, SNR_N] power samples ring
    snr_v: jax.Array     # [C, SNR_N] variance samples ring
    snr_fill: jax.Array  # samples seen (int32) — ring warm-up
    prev_p_re: jax.Array  # previous prompt vector (FLL discriminator)
    prev_p_im: jax.Array


class TrackLog(NamedTuple):
    """Per-step outputs (stacked to [steps, C] by scan)."""
    iE: jax.Array
    qE: jax.Array
    iP: jax.Array
    qP: jax.Array
    iL: jax.Array
    qL: jax.Array
    rc: jax.Array
    ri: jax.Array
    fc: jax.Array
    fi: jax.Array
    cp: jax.Array
    ncp: jax.Array       # code periods completed this step (0/1/2)
    signs: jax.Array     # [C, 2] nav-bit signs for completed periods
    lock: jax.Array
    lockval: jax.Array
    snr: jax.Array
    dpc: jax.Array       # DLL discriminator output
    dpi: jax.Array       # PLL discriminator output


def init_state(rc, ri, fc, fi, cp=None) -> TrackState:
    """Build a TrackState from acquisition results (sets loop biases)."""
    rc = np.asarray(rc, dtype=np.float32)
    c = rc.shape[0]
    fi = np.asarray(fi, dtype=np.float32)
    dfc = np.asarray(fc, dtype=np.float64) - F_CA
    zeros = np.zeros(c, dtype=np.float32)
    izeros = np.zeros(c, dtype=np.int32)
    return TrackState(
        rc=jnp.asarray(rc),
        dfc=jnp.asarray(dfc.astype(np.float32)),
        ri=jnp.asarray(np.asarray(ri, dtype=np.float32)),
        fi=jnp.asarray(fi),
        dfc_bias=jnp.asarray(dfc.astype(np.float32)),
        fi_bias=jnp.asarray(fi),
        cp=jnp.asarray(izeros if cp is None else np.asarray(cp, np.int32)),
        p_a_re=jnp.asarray(zeros), p_a_im=jnp.asarray(zeros),
        lf_code_h=jnp.asarray(zeros), lf_carr_h=jnp.asarray(zeros),
        lf_code_h2=jnp.asarray(zeros), lf_carr_h2=jnp.asarray(zeros),
        lock_i=jnp.asarray(zeros), lock_q=jnp.asarray(zeros),
        losscount=jnp.asarray(izeros), lockcount=jnp.asarray(izeros),
        lock=jnp.asarray(izeros),
        snr_z=jnp.zeros((c, SNR_N), jnp.float32),
        snr_v=jnp.zeros((c, SNR_N), jnp.float32),
        snr_fill=jnp.asarray(izeros),
        prev_p_re=jnp.asarray(zeros), prev_p_im=jnp.asarray(zeros),
    )


def _chip_indices(base: jax.Array, phase: jax.Array) -> jax.Array:
    """floor(base + phase) mod 1023 as [C, S] float32."""
    return jnp.mod(jnp.floor(base[None, :] + phase[:, None]),
                   np.float32(L_CA))


def _chips_onehot(code_table: jax.Array, base: jax.Array,
                  phase: jax.Array) -> jax.Array:
    """Gather-free chip lookup: chips[floor(base + phase) mod 1023].

    code_table: [C, 1023]; base: [S] nominal chip index; phase: [C] chips.
    One-hot matmul — the gather-free form of the lookup.
    """
    idx = _chip_indices(base, phase)                       # [C, S]
    k = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1023), 2).astype(jnp.float32)
    onehot = (idx[:, :, None] == k).astype(jnp.float32)
    return jnp.einsum("csk,ck->cs", onehot, code_table,
                      preferred_element_type=jnp.float32)


def _chips_gather(code_table: jax.Array, base: jax.Array,
                  phase: jax.Array) -> jax.Array:
    """Direct-gather chip lookup — same result as _chips_onehot at
    O(C*S) instead of O(C*S*1023); for backends with full XLA gather
    (CPU/GPU)."""
    idx = _chip_indices(base, phase).astype(jnp.int32)     # [C, S]
    return jnp.take_along_axis(code_table, idx, axis=1)


def _epl_onehot(code_table: jax.Array, base: jax.Array,
                phase: jax.Array) -> jax.Array:
    """All three E/P/L replicas from ONE half-chip one-hot contraction.

    The taps chips[floor(x+1/2)], chips[floor(x)], chips[floor(x-1/2)]
    are all determined by j = floor(2x):  floor(x+1/2) == (j+1)//2,
    floor(x) == j//2, floor(x-1/2) == (j-1)//2 (exact integer identities).
    So one one-hot over 2046 half-chip bins against a [C, 2046, 3] table
    replaces three 1023-bin lookups — 2/3 the compare volume and one
    contraction instead of three. The table is built gather-free:
    repeat(code, 2) gives the P row; rolling it by -/+1 gives E/L.

    code_table: [C, 1023]; base: [S]; phase: [C]. Returns [C, S, 3]
    (E, P, L order).
    """
    r = jnp.repeat(code_table, 2, axis=1)                  # [C, 2046] P row
    tab3 = jnp.stack([jnp.roll(r, -1, axis=1), r,
                      jnp.roll(r, 1, axis=1)], axis=-1)    # [C, 2046, 3]
    x = base[None, :] + phase[:, None]                     # [C, S] chips
    j = jnp.mod(jnp.floor(2.0 * x), np.float32(2 * L_CA))
    k = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 2 * int(L_CA)),
                                 2).astype(jnp.float32)
    onehot = (j[:, :, None] == k).astype(jnp.float32)      # [C, S, 2046]
    return jnp.einsum("csk,ckt->cst", onehot, tab3,
                      preferred_element_type=jnp.float32)


_FACT_HI = 93    # 2046 == _FACT_HI * _FACT_LO (exact)
_FACT_LO = 22


def _epl_onehot_factored(code_table: jax.Array, base: jax.Array,
                         phase: jax.Array) -> jax.Array:
    """Two-level factored half-chip one-hot: bit-exact `_epl_onehot` at
    ~1/18 the compare volume.

    The 2046-bin index factors as j = 22*h + l (h in [0,93), l in [0,22)),
    so the [C, S, 2046] one-hot — whose construction (C*S*2046 compares +
    selects per window) is what the tracking scan is compute-bound on
    — becomes
    two one-hots of [C, S, 93] and [C, S, 22]. Stage 1 contracts the hi
    one-hot against the table regrouped as [C, 93, 22*3] (same 2046*3
    MACs per sample as the direct form — the matmul work does not grow);
    stage 2 is a 22-long masked reduce. Every operand is
    exactly representable in bf16 (one-hots are 0/1, chips are +-1), so
    the result equals the direct gather bit-for-bit.
    """
    r = jnp.repeat(code_table, 2, axis=1)                  # [C, 2046] P row
    tab3 = jnp.stack([jnp.roll(r, -1, axis=1), r,
                      jnp.roll(r, 1, axis=1)], axis=-1)    # [C, 2046, 3]
    tab_hi = tab3.reshape(-1, _FACT_HI, _FACT_LO * 3)      # [C, 93, 66]

    x = base[None, :] + phase[:, None]                     # [C, S] chips
    j = jnp.mod(jnp.floor(2.0 * x), np.float32(2 * L_CA))  # integer-valued
    # h = j // 22 via floor((j + 0.5)/22): the +0.5 keeps the quotient
    # >= 0.02 away from every integer, so the f32 division can't round
    # floor() across a boundary (j*(1/22) alone can, at j = 22k)
    h = jnp.floor((j + 0.5) * np.float32(1.0 / _FACT_LO))
    l = j - np.float32(_FACT_LO) * h                       # exact (ints)
    kh = jax.lax.broadcasted_iota(jnp.int32, (1, 1, _FACT_HI),
                                  2).astype(jnp.float32)
    kl = jax.lax.broadcasted_iota(jnp.int32, (1, 1, _FACT_LO),
                                  2).astype(jnp.float32)
    oh_h = (h[:, :, None] == kh).astype(jnp.float32)       # [C, S, 93]
    oh_l = (l[:, :, None] == kl).astype(jnp.float32)       # [C, S, 22]
    u = jnp.einsum("csh,chx->csx", oh_h, tab_hi,
                   preferred_element_type=jnp.float32)     # [C, S, 66]
    u = u.reshape(u.shape[0], u.shape[1], _FACT_LO, 3)
    return jnp.einsum("csl,cslt->cst", oh_l, u,
                      preferred_element_type=jnp.float32)  # [C, S, 3]


def _epl_gather(code_table: jax.Array, base: jax.Array,
                phase: jax.Array) -> jax.Array:
    """Direct-gather E/P/L replicas [C, S, 3] (backends with XLA gather)."""
    return jnp.stack([_chips_gather(code_table, base, phase + 0.5),
                      _chips_gather(code_table, base, phase),
                      _chips_gather(code_table, base, phase - 0.5)],
                     axis=-1)


@functools.lru_cache(maxsize=8)
def _half_chip_consts(period: int):
    """Compile-time constant half-chip lookup tables for one code period.

    Period == T_CA * fs exactly, so the nominal half-chip index
    j0[k] = floor(2 * k * F_CA / fs) and its fraction are data-independent
    constants; 2046 = 93 * 22 factors them into two constant one-hot
    matrices (the ops/dpe_real.py `_chip_lookup_consts` idea at half-chip
    resolution + the `_epl_onehot_factored` digit split). Returns numpy
    (e_hi [period, 93], e_lo [period, 22], frac2 [period])."""
    l2 = 2 * int(L_CA)
    base2 = np.arange(period) * (l2 / float(period))       # exact f64
    j0 = np.floor(base2).astype(np.int64) % l2
    frac2 = (base2 - np.floor(base2)).astype(np.float32)
    e_hi = np.zeros((period, _FACT_HI), np.float32)
    e_hi[np.arange(period), j0 // _FACT_LO] = 1.0
    e_lo = np.zeros((period, _FACT_LO), np.float32)
    e_lo[np.arange(period), j0 % _FACT_LO] = 1.0
    return e_hi, e_lo, frac2


def _epl_const_fold(code_table: jax.Array, phase: jax.Array,
                    period: int, n_periods: int = 1) -> jax.Array:
    """E/P/L replicas [C, S, 3] via CONSTANT one-hot tables + per-channel
    roll — zero per-sample compare volume, exactly periodic tiling.

    The half-chip index splits as floor(2*base0[k] + 2*rc) = j0[k] + s2 +
    carry(k), with j0 constant and s2 = floor(2*rc) per channel: the phase
    dependence becomes ONE dynamic-slice roll of the doubled half-chip
    sequence (per channel, like ops/dpe_real._lag_matrix) plus a [C, P0]
    carry mask, and the j0 lookup contracts against compile-time-constant
    e_hi/e_lo matrices (93 x 22 digit split). This removes the
    [C, S, 93] + [C, S, 22] phase-dependent one-hot build — the
    compare volume the tracking scan was measured compute-bound on — and,
    because base0 advances exactly L_CA chips per period, the replica is
    EXACTLY periodic: computed once per code period and tiled n_periods
    times (an n_periods-fold saving for coherent windows, coh_ms > 1).

    The taps come from four shifted reads y_e (e in {-1, 0, 1, 2}) of the
    rolled sequence combined through the carry:
        P = y0 + carry*(y1 - y0);  E = y1 + carry*(y2 - y1);
        L = y-1 + carry*(y0 - y-1)
    (E row = r2[j+1], L row = r2[j-1]: _epl_onehot's integer identities).
    All operands are exact in f32 (one-hots 0/1, chips +-1), so the result
    equals an exact-arithmetic gather bit-for-bit; it differs from
    `_epl_gather(code_table, base, phase)` only where the f32 rounding of
    base = f32(k/fs)*F_CA lands a half-chip boundary on the other side of
    a sample (~1 sample per window, a more exact decision here).
    """
    c = code_table.shape[0]
    e_hi_np, e_lo_np, frac2_np = _half_chip_consts(period)
    e_hi = jnp.asarray(e_hi_np)
    e_lo = jnp.asarray(e_lo_np)
    frac2 = jnp.asarray(frac2_np)
    l2 = 2 * int(L_CA)

    r2 = jnp.repeat(code_table, 2, axis=1)                 # [C, 2046]
    r2d = jnp.concatenate([r2, r2, r2[:, :4]], axis=1)     # [C, 2*2046+4]

    ph = jnp.mod(phase, np.float32(L_CA))
    s2 = jnp.floor(2.0 * ph).astype(jnp.int32)             # [C] in [0, 2046)
    fr = 2.0 * ph - jnp.floor(2.0 * ph)                    # [C] frac

    # rolled[-1 .. 2046+2]: one per-channel slice covers all four shifts
    def sl(row, st):
        return jax.lax.dynamic_slice(row, (st,), (l2 + 3,))

    ext = jax.vmap(sl)(r2d, jnp.mod(s2 - 1, np.int32(l2)))  # [C, 2049]
    shifts = jnp.stack([ext[:, e + 1:e + 1 + l2]
                        for e in (-1, 0, 1, 2)], axis=1)    # [C, 4, 2046]
    rsh = shifts.reshape(c, 4, _FACT_HI, _FACT_LO)          # [C,4,93,22]

    # constant-table lookup: A[c,e,k,l] = sum_h e_hi[k,h] * rsh[c,e,h,l]
    a = jnp.einsum("kh,cehl->cekl", e_hi, rsh,
                   preferred_element_type=jnp.float32)      # [C,4,P0,22]
    y = jnp.einsum("kl,cekl->cek", e_lo, a,
                   preferred_element_type=jnp.float32)      # [C,4,P0]

    carry = ((frac2[None, :] + fr[:, None]) >= np.float32(1.0)
             ).astype(jnp.float32)                          # [C, P0]
    ym1, y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
    e_tap = y1 + carry * (y2 - y1)
    p_tap = y0 + carry * (y1 - y0)
    l_tap = ym1 + carry * (y0 - ym1)
    repl = jnp.stack([e_tap, p_tap, l_tap], axis=-1)        # [C, P0, 3]
    if n_periods > 1:
        repl = jnp.tile(repl, (1, n_periods, 1))            # [C, S, 3]
    return repl


REPLICA_STRATEGIES = ("gather", "factored", "constfold", "onehot")


def _epl_replicas(code_table, base, phase, period: int | None = None,
                  n_periods: int = 1, strategy: str = "gather"):
    """E/P/L replica stack [C, S, 3] by the named construction.

    "gather" (the default) indexes the chip table directly. "factored",
    "onehot" and "constfold" build the same replicas gather-free from
    one-hot contractions; "constfold" computes one code period and tiles
    it, so it needs the window to be whole nominal code periods
    (`period` given) and otherwise falls back to "factored"."""
    if strategy == "constfold":
        if period is None:
            return _epl_onehot_factored(code_table, base, phase)
        return _epl_const_fold(code_table, phase, period, n_periods)
    if strategy == "factored":
        return _epl_onehot_factored(code_table, base, phase)
    if strategy == "onehot":
        return _epl_onehot(code_table, base, phase)
    if strategy == "gather":
        return _epl_gather(code_table, base, phase)
    raise ValueError(f"unknown replica strategy {strategy!r}; expected one "
                     f"of {REPLICA_STRATEGIES}")


def _correlate_step(state: TrackState, raw_re: jax.Array, raw_im: jax.Array,
                    code_table: jax.Array, time_idc: jax.Array, fs: float,
                    m: int = 1, strategy: str = "gather"):
    """E/P/L correlation of one m-ms window for all channels.

    raw_re/raw_im: [S] float32 (shared across channels), S = m samples/ms;
    code_table: [C, 1023] f32. Returns per-code-period segment sums as
    (re, im) pairs e_s/p_s/l_s: [C, m+2, 2] float32 and ncp [C] int32
    (code periods completed this window, in {m-1, m, m+1}). All-real:
    runs on backends without complex64 support.

    Gather-free: the window is m code periods at the nominal rate, so
    replicas come from a one-hot chip lookup at the mid-window phase
    (within-window drift dfc*m*1e-3 < 4e-3*m chips — 0.013 chips at
    m = 4 with |dfc| <= 3.3 chips/s — far below discriminator noise)
    and segment membership is an arithmetic sample-index threshold.
    m > 1 is the coherent predetection-integration mode (the reference
    scaffolds N-ms accumulation in channel.get_Nms_correlation,
    channel.py:344-422, but never drives its loops with it).
    """
    s = raw_re.shape[0]
    n_seg = m + 2
    # carrier wipeoff (w = exp(-2pi i(fi t + ri))), all-real arithmetic
    ang = 2.0 * jnp.pi * (state.fi[:, None] * time_idc[None, :]
                          + state.ri[:, None])
    wc, ws = jnp.cos(ang), jnp.sin(ang)
    bb_re = raw_re[None, :] * wc + raw_im[None, :] * ws
    bb_im = raw_im[None, :] * wc - raw_re[None, :] * ws

    base = time_idc * np.float32(F_CA)                     # [S]
    rc_mid = state.rc + state.dfc * np.float32(m * 0.5e-3)
    # samples per code period — the const-fold path needs the window to
    # be exactly m code periods at the nominal rate (T_CA * fs integer)
    period = (s // m if s % m == 0 and abs(s / m - fs * 1e-3) < 1e-6
              else None)
    replicas = _epl_replicas(code_table, base, rc_mid, period=period,
                             n_periods=m, strategy=strategy)  # [C, S, 3]

    # code-period boundaries: fidc = base + t*dfc + rc crosses k*L_CA at
    # sample ~ (k*L_CA - rc) * fs / fc, for k = 1..m+1
    fc = np.float32(F_CA) + state.dfc
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1).astype(jnp.float32)
    seg = None
    for k in range(1, m + 2):
        bk = (np.float32(k * L_CA) - state.rc) * (np.float32(fs) / fc)
        term = (cols >= bk[:, None]).astype(jnp.int32)       # [C, S]
        seg = term if seg is None else seg + term

    # all 3*(m+2) (tap, segment) sums in one small matmul: weight each
    # sample by replica-tap x segment-membership, contract the sample axis
    # against the (re, im) baseband. f32 HIGHEST precision: bb carries
    # raw-sample magnitudes, and the E-L discriminator is a small
    # difference of large correlation sums — don't let the matmul round the
    # operands to bf16.
    segm = (seg[:, :, None]
            == jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_seg), 2)
            ).astype(jnp.float32)                           # [C, S, n_seg]
    w = (replicas[:, :, :, None] * segm[:, :, None, :]
         ).reshape(replicas.shape[0], s, 3 * n_seg)         # [C, S, 3*n_seg]
    bb = jnp.stack([bb_re, bb_im], axis=1)                  # [C, 2, S]
    sums = jnp.einsum("cps,csx->cpx", bb, w,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    sums = sums.reshape(-1, 2, 3, n_seg)                    # [C, 2, tap, seg]
    e_s = jnp.moveaxis(sums[:, :, 0, :], 1, 2)              # [C, n_seg, 2]
    p_s = jnp.moveaxis(sums[:, :, 1, :], 1, 2)
    l_s = jnp.moveaxis(sums[:, :, 2, :], 1, 2)

    ncp = jnp.floor((np.float32(s / fs) * fc + state.rc)
                    * np.float32(1.0 / L_CA)).astype(jnp.int32)
    return e_s, p_s, l_s, ncp


def _polarity_combine(state: TrackState, e_s, p_s, l_s, ncp, m: int = 1):
    """Receiver-synchronous combination with nav-bit polarity resolution
    (reference correlator.py:162-279). Segment sums are [C, m+2, 2]
    (re, im).

    m == 1 reproduces the reference's 3-segment decision tree exactly.
    m > 1 uses a flip-location hypothesis test: nav bits last 20 code
    periods, so for m <= 10 at most ONE boundary inside the window
    carries a real flip. Deciding WHERE (or whether) it is from the
    full-window combined energy — argmax over the n_seg single-flip
    hypotheses |sum_{k<j} s_k - sum_{k>=j} s_k|^2 — stays reliable at
    C/N0 where per-segment pairwise decisions (1 ms of energy each, the
    reference's approach) are coin flips; this is what lets the
    coherent mode track through weak signal instead of being destroyed
    by its own polarity resolution."""
    sums = e_s + p_s + l_s                                  # [C, n_seg, 2]
    n_seg = m + 2

    def mag2(x):
        return x[..., 0] ** 2 + x[..., 1] ** 2

    if m == 1:
        flip01 = mag2(sums[:, 0] + sums[:, 1]) < mag2(sums[:, 0] - sums[:, 1])
        flip12 = mag2(sums[:, 1] + sums[:, 2]) < mag2(sums[:, 1] - sums[:, 2])
        g1 = jnp.where(flip01, -1.0, 1.0).astype(jnp.float32)
        g2 = jnp.where(flip01, -1.0,
                       jnp.where(flip12, -1.0, 1.0)).astype(jnp.float32)
        g = jnp.stack([jnp.ones_like(g1), g1, g2], axis=1)  # [C, 3]
    else:
        tot = jnp.sum(sums, axis=1)                         # [C, 2]
        cum = jnp.cumsum(sums, axis=1)                      # [C, n_seg, 2]
        # hypothesis j: segments k >= j flipped (j = 0: no flip);
        # combined sum under j >= 1 is 2*cum_{j-1} - tot
        cand = jnp.concatenate(
            [tot[:, None], 2.0 * cum[:, :-1] - tot[:, None]],
            axis=1)                                         # [C, n_seg, 2]
        jstar = jnp.argmax(mag2(cand), axis=1)              # [C]
        k_iota = jax.lax.broadcasted_iota(jnp.int32, (1, n_seg), 1)
        g = jnp.where((jstar[:, None] == 0)
                      | (k_iota < jstar[:, None]), 1.0, -1.0
                      ).astype(jnp.float32)                 # [C, n_seg]

    # g[:, 0] == +1 in both branches (a "flip before segment 0" is the
    # same bit as no flip); elementwise adds, not einsum — the operands
    # must stay f32 (reduced-precision matmuls would blur the
    # discriminators)
    def comb(x):
        acc = x[:, 0]
        for k in range(1, n_seg):
            acc = acc + g[:, k][:, None] * x[:, k]
        return acc                                          # [C, 2]

    e_r, p_r, l_r = comb(e_s), comb(p_s), comb(l_s)

    # signal-synchronous prompt sums for nav-bit signs: the k-th completed
    # code period's prompt is segment k-1 (segment 0 completes the period
    # carried in from the previous window via p_a)
    p_s1_re = state.p_a_re + p_s[:, 0, 0]
    signs = jnp.stack([-jnp.sign(p_s1_re)]
                      + [-jnp.sign(p_s[:, k, 0])
                         for k in range(1, n_seg - 1)], axis=1)  # [C, m+1]

    # the carry for the next window is the last (incomplete) segment's
    # prompt sum — segment index ncp — plus the existing carry when no
    # period completed at all. One-hot select over the few segments.
    def pick(part):
        carry = state.p_a_re if part == 0 else state.p_a_im
        acc = jnp.where(ncp == 0, carry + p_s[:, 0, part], 0.0)
        for k in range(1, n_seg):
            acc = acc + jnp.where(ncp == k, p_s[:, k, part], 0.0)
        return acc

    p_a_re_new = pick(0)
    p_a_im_new = pick(1)
    return e_r, p_r, l_r, signs, p_a_re_new, p_a_im_new


def _lock_snr_update(state: TrackState, p_r, m: int = 1):
    """Kaplan-Hegarty lock detector + variance-summing C/N0 meter.
    p_r: [C, 2] (re, im). For m > 1 the per-update LPF coefficient and
    count thresholds are rescaled so the detector's TIME constants match
    the 1 ms design (updates arrive m x slower); the C/N0 meter's
    predetection time is m*T_MS."""
    ip, qp = p_r[:, 0], p_r[:, 1]

    lpf = 1.0 - (1.0 - LOCK_LPF) ** m    # == LOCK_LPF at m = 1
    loss_th = max(1, round(LOCK_LOSS_TH / m))
    lock_th = max(1, round(LOCK_LOCK_TH / m))
    li = lpf * jnp.abs(ip) + (1 - lpf) * state.lock_i
    lq = lpf * jnp.abs(qp) + (1 - lpf) * state.lock_q
    in_lock = (li / LOCK_K) > lq
    losscount = jnp.where(in_lock, 0, state.losscount + 1)
    lockcount = jnp.where(in_lock, state.lockcount + 1, 0)
    lock = jnp.where(in_lock & (state.lockcount > lock_th), 1,
                     jnp.where(~in_lock & (state.losscount > loss_th),
                               0, state.lock))
    lockval = li / LOCK_K - lq

    # SNR: rings of the last N power / variance samples
    z = ip * ip + qp * qp
    snr_z = jnp.concatenate([state.snr_z[:, 1:], z[:, None]], axis=1)
    z_mean = jnp.mean(snr_z, axis=1)
    v = (z - z_mean) ** 2
    snr_v = jnp.concatenate([state.snr_v[:, 1:], v[:, None]], axis=1)
    z_var = jnp.mean(snr_v, axis=1)
    carrier = jnp.sqrt(jnp.maximum(z_mean * z_mean - z_var, 0.0))
    noise_var = jnp.maximum((z_mean - carrier) / 2.0, 1e-12)
    logarg = jnp.maximum(carrier / (2.0 * (SNR_N * m * T_MS) * noise_var),
                         1.0)
    snr = 10.0 * jnp.log10(logarg)

    new = state._replace(lock_i=li, lock_q=lq, losscount=losscount,
                         lockcount=lockcount, lock=lock, snr_z=snr_z,
                         snr_v=snr_v, snr_fill=state.snr_fill + 1)
    return new, lock, lockval, snr


def _lf_step(h, h2, xp, xf, coeffs, boxcar: bool, t_s: float = T_MS):
    """One loop-filter update (reference loopfilter.py:91-121, filters.py
    Bilinear/BoxcarIntegrator). Returns (h', h2', out).

    order 2: out = integ(Kvp*xp + Kvf*xf) + Kpp*xp       (Kap == Kaf == 0)
    order 3: out = integ(integ(Kap*xp + Kaf*xf) + Kvp*xp + Kvf*xf) + Kpp*xp
    integ is bilinear ((h+h')/2) or boxcar (h') with gain t_s (the update
    period — T_MS, or m*T_MS under coherent predetection integration).
    """
    kap, kvp, kpp, kaf, kvf = (np.float32(c) for c in coeffs)
    t = np.float32(t_s)

    def integ(acc, x):
        acc_new = acc + t * x
        out = acc_new if boxcar else (acc_new + acc) * 0.5
        return acc_new, out

    if float(kap) == 0.0 and float(kaf) == 0.0:   # pure 2nd-order: skip h2
        acc_out = 0.0
        h2_new = h2
    else:
        h2_new, acc_out = integ(h2, kap * xp + kaf * xf)
    h_new, vel_out = integ(h, acc_out + kvp * xp + kvf * xf)
    return h_new, h2_new, vel_out + kpp * xp


def _loops_update(state: TrackState, e_r, p_r, l_r, fcaid: float,
                  loops: LoopConfig, m: int = 1):
    """DLL/PLL discriminators -> loop filters -> new fc/fi.
    e_r/p_r/l_r: [C, 2] (re, im). m is the update period in ms (coherent
    predetection integration: discriminators unchanged, integrator gain
    and FLL normalization scale with the period; FLL pull-in range is
    +/- 1/(2*m*T_MS) Hz)."""
    ip, qp = p_r[:, 0], p_r[:, 1]
    dpi = jnp.where(ip != 0.0, jnp.arctan(qp / jnp.where(ip == 0, 1.0, ip))
                    / (2.0 * np.pi), 0.0).astype(jnp.float32)

    e_env = jnp.sqrt(e_r[:, 0] ** 2 + e_r[:, 1] ** 2)
    l_env = jnp.sqrt(l_r[:, 0] ** 2 + l_r[:, 1] ** 2)
    denom = e_env + l_env
    dpc = jnp.where(denom != 0.0,
                    (e_env - l_env) / (2.0 * jnp.maximum(denom, 1e-30)),
                    0.0).astype(jnp.float32)

    zero = jnp.zeros_like(dpi)
    if loops.bn_carr_freq > 0.0:
        # FLL discriminator (reference discriminator.py:56-69): frequency
        # error in Hz from the rotation of the prompt vector between
        # consecutive 1 ms windows, atan2(cross, dot) with the dot sign
        # normalized so 180-degree nav-bit flips cancel. First step has a
        # zero previous prompt -> atan2(0, 0) == 0 (no kick).
        cross = state.prev_p_re * qp - ip * state.prev_p_im
        dot = state.prev_p_re * ip + state.prev_p_im * qp
        sgn = jnp.where(dot < 0.0, -1.0, 1.0).astype(jnp.float32)
        xf = (jnp.arctan2(sgn * cross, sgn * dot)
              / np.float32(2.0 * np.pi * m * T_MS)).astype(jnp.float32)
    else:
        xf = zero
    t_s = m * T_MS
    lf_carr_h, lf_carr_h2, di = _lf_step(
        state.lf_carr_h, state.lf_carr_h2, dpi, xf,
        _loop_coeffs(loops.order, loops.bn_carr, loops.bn_carr_freq),
        loops.boxcar, t_s)
    lf_code_h, lf_code_h2, dc = _lf_step(
        state.lf_code_h, state.lf_code_h2, dpc, zero,
        _loop_coeffs(loops.order, loops.bn_code, 0.0), loops.boxcar, t_s)

    fi_new = state.fi_bias + di
    dfc_new = state.dfc_bias + dc + np.float32(fcaid) * (state.fi_bias + di)
    return state._replace(fi=fi_new, dfc=dfc_new, lf_carr_h=lf_carr_h,
                          lf_code_h=lf_code_h, lf_carr_h2=lf_carr_h2,
                          lf_code_h2=lf_code_h2,
                          prev_p_re=ip, prev_p_im=qp), dpc, dpi


@functools.partial(jax.jit,
                   static_argnames=("fs", "fcaid", "loops", "coh_ms",
                                    "unroll", "strategy"))
def track_chunk(state: TrackState, raw_chunk: jax.Array,
                code_table: jax.Array, fs: float, fcaid: float,
                loops: LoopConfig = LoopConfig(), coh_ms: int = 1,
                unroll: int = SCAN_UNROLL, strategy: str = "gather"):
    """Track a chunk of consecutive coh_ms-long windows.

    raw_chunk: [steps, S, 2] float32 (re, im last axis) or [steps, S]
    complex (converted), S = coh_ms * samples-per-ms. `loops` selects
    filter order/bandwidths (reference channel.py:57-58 defaults).
    Returns (final_state, TrackLog stacked over steps).

    coh_ms > 1 is coherent predetection integration: each loop update
    integrates coh_ms code periods coherently (per-period polarity
    resolved by the segment machinery, so nav-bit flips inside the
    window are handled and the per-period cp_sign stream is preserved
    for LNAV decode). The value is SENSITIVITY: ~3 dB more
    discriminator SNR per doubling (27 dB-Hz tracking at m=8 where the
    1 ms loop drops lock). The trade: loop update rate drops to
    1/(coh_ms ms) (use with Bn*coh_ms*1e-3 << 1) and the FLL pull-in
    range shrinks to +/-1/(2*coh_ms*1e-3) Hz. The reference scaffolds
    N-ms accumulation (channel.get_Nms_correlation, channel.py:344-422)
    but never drives its loops with it; here it is a first-class mode.
    """
    m = int(coh_ms)
    if not 1 <= m <= 10:
        # > 10 would let a window span two nav-bit boundaries, which the
        # single-flip hypothesis test cannot represent (silently corrupt
        # polarity); the practical sweet spot is 2-8
        raise ValueError(f"coh_ms must be in 1..10, got {m}")
    if jnp.iscomplexobj(raw_chunk):
        raw_chunk = jnp.stack([jnp.real(raw_chunk), jnp.imag(raw_chunk)],
                              axis=-1).astype(jnp.float32)
    elif jnp.issubdtype(raw_chunk.dtype, jnp.integer):
        # int16 I/Q accepted directly: a quarter of the float32 upload
        raw_chunk = raw_chunk.astype(jnp.float32)
    s = raw_chunk.shape[1]
    time_idc = (jnp.arange(s) / fs).astype(jnp.float32)
    t_up = np.float32(m * T_MS)

    def body(st: TrackState, raw):
        e_s, p_s, l_s, ncp = _correlate_step(st, raw[:, 0], raw[:, 1],
                                             code_table, time_idc, fs, m,
                                             strategy)
        (e_r, p_r, l_r, signs, p_a_re_new,
         p_a_im_new) = _polarity_combine(st, e_s, p_s, l_s, ncp, m)
        st1, lock, lockval, snr = _lock_snr_update(
            st._replace(p_a_re=p_a_re_new, p_a_im=p_a_im_new), p_r, m)

        log = TrackLog(
            iE=e_r[:, 0], qE=e_r[:, 1],
            iP=p_r[:, 0], qP=p_r[:, 1],
            iL=l_r[:, 0], qL=l_r[:, 1],
            rc=st.rc, ri=st.ri, fc=np.float32(F_CA) + st.dfc, fi=st.fi,
            cp=st.cp, ncp=ncp, signs=signs, lock=lock, lockval=lockval,
            snr=snr, dpc=jnp.zeros_like(st.rc), dpi=jnp.zeros_like(st.rc))

        # time update with pre-update fc/fi (reference sequencing)
        rc_new = jnp.mod(st.rc + st.dfc * t_up, np.float32(L_CA))
        ri_new = jnp.mod(st.ri + st.fi * t_up, 1.0)
        cp_new = st.cp + ncp

        st2 = st1._replace(rc=rc_new, ri=ri_new, cp=cp_new)
        # measurement update -> fc/fi for the next window
        st3, dpc, dpi = _loops_update(st2, e_r, p_r, l_r, fcaid, loops, m)
        log = log._replace(dpc=dpc, dpi=dpi)
        return st3, log

    return jax.lax.scan(body, state, raw_chunk, unroll=int(unroll))


def _correlate_windows_batched(state: TrackState, raw_k, code_table,
                               time_idc, fs: float, k: int):
    """E/P/L segment sums for k consecutive 1 ms windows in ONE batched
    correlation pass, with window phases PREDICTED from the batch-start
    rates (rc_w = rc + dfc*w*T, ri_w = ri + fi*w*T — the predictor of
    track_chunk's batch_k mode). raw_k: [k, S, 2]. Returns
    (e_s, p_s, l_s: [k, C, 3, 2], ncp [k, C], rc_w [k, C], ri_w [k, C]).

    The k windows become k*C virtual channels through the replica lookup
    and the segment contraction — identical arithmetic volume to k
    sequential steps, 1/k the op count."""
    c = code_table.shape[0]
    s = time_idc.shape[0]
    w_i = jnp.arange(k, dtype=jnp.float32)[:, None]         # [k, 1]
    rc_w = jnp.mod(state.rc[None, :] + state.dfc[None, :] * T_MS * w_i,
                   np.float32(L_CA))                        # [k, C]
    ri_w = jnp.mod(state.ri[None, :] + state.fi[None, :] * T_MS * w_i, 1.0)

    ang = 2.0 * jnp.pi * (state.fi[None, :, None] * time_idc[None, None, :]
                          + ri_w[:, :, None])               # [k, C, S]
    wc, ws = jnp.cos(ang), jnp.sin(ang)
    raw_re = raw_k[:, None, :, 0]
    raw_im = raw_k[:, None, :, 1]
    bb_re = (raw_re * wc + raw_im * ws).reshape(k * c, s)
    bb_im = (raw_im * wc - raw_re * ws).reshape(k * c, s)

    base = time_idc * np.float32(F_CA)
    rc_mid = (rc_w + state.dfc[None, :] * np.float32(0.5e-3)).reshape(-1)
    tab_k = jnp.tile(code_table, (k, 1))                    # [kC, 1023]
    period = s if abs(s - fs * 1e-3) < 1e-6 else None
    replicas = _epl_replicas(tab_k, base, rc_mid, period=period,
                             n_periods=1)                   # [kC, S, 3]

    fc = np.float32(F_CA) + state.dfc                       # [C]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1).astype(jnp.float32)
    seg = None
    rc_flat = rc_w.reshape(-1)
    fc_flat = jnp.tile(fc, (k,))
    for j in range(1, 3):
        bk = (np.float32(j * L_CA) - rc_flat) * (np.float32(fs) / fc_flat)
        term = (cols >= bk[:, None]).astype(jnp.int32)
        seg = term if seg is None else seg + term
    n_seg = 3
    segm = (seg[:, :, None]
            == jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_seg), 2)
            ).astype(jnp.float32)                           # [kC, S, 3]
    w = (replicas[:, :, :, None] * segm[:, :, None, :]
         ).reshape(k * c, s, 3 * n_seg)
    bb = jnp.stack([bb_re, bb_im], axis=1)                  # [kC, 2, S]
    sums = jnp.einsum("cps,csx->cpx", bb, w,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    sums = sums.reshape(k, c, 2, 3, n_seg)
    e_s = jnp.moveaxis(sums[:, :, :, 0, :], 2, 3)           # [k, C, 3, 2]
    p_s = jnp.moveaxis(sums[:, :, :, 1, :], 2, 3)
    l_s = jnp.moveaxis(sums[:, :, :, 2, :], 2, 3)
    ncp = jnp.floor((np.float32(s / fs) * fc_flat + rc_flat)
                    * np.float32(1.0 / L_CA)).astype(jnp.int32).reshape(k, c)
    return e_s, p_s, l_s, ncp, rc_w, ri_w


@functools.partial(jax.jit,
                   static_argnames=("fs", "fcaid", "loops", "batch_k",
                                    "unroll"))
def track_chunk_batched(state: TrackState, raw_chunk: jax.Array,
                        code_table: jax.Array, fs: float, fcaid: float,
                        loops: LoopConfig = LoopConfig(), batch_k: int = 4,
                        unroll: int = 1):
    """track_chunk with k-window batched correlation (predictor-corrector).

    Each scan body correlates batch_k consecutive 1 ms windows in one
    batched pass using phases predicted from the batch-start rates, then
    runs the batch_k measurement updates (polarity, lock/SNR, DLL/PLL
    filters) sequentially on the tiny correlator outputs. Discriminators
    still fire every 1 ms; only the NCO phases the correlator used lag
    the loop filter by up to batch_k windows — a transport delay of
    batch_k*T_MS (phase-margin erosion ~w0*k*T: 17 deg at the 40 Hz
    default PLL with k = 4; keep k <= 4 at default bandwidths). Rates
    within the batch are frozen, so trajectories match the 1 ms loop to
    the size of one batch's rate correction (~1e-3 chips), not
    bit-exactly — the win is ~1/k of the per-op dispatch overhead that
    bounds the sequential scan.

    raw_chunk: [steps, S, 2] with steps % batch_k == 0. Returns
    (final_state, TrackLog) with per-1-ms rows, same as track_chunk.
    """
    k = int(batch_k)
    if jnp.iscomplexobj(raw_chunk):
        raw_chunk = jnp.stack([jnp.real(raw_chunk), jnp.imag(raw_chunk)],
                              axis=-1).astype(jnp.float32)
    steps, s = raw_chunk.shape[0], raw_chunk.shape[1]
    if steps % k:
        raise ValueError(f"steps {steps} not divisible by batch_k {k}")
    time_idc = (jnp.arange(s) / fs).astype(jnp.float32)
    t_up = np.float32(T_MS)

    def body(st: TrackState, raw_k):
        e_s, p_s, l_s, ncp, rc_w, ri_w = _correlate_windows_batched(
            st, raw_k, code_table, time_idc, fs, k)
        dfc0, fi0 = st.dfc, st.fi           # frozen predictor rates
        logs = []
        for w in range(k):
            stw = st._replace(rc=rc_w[w], ri=ri_w[w])
            (e_r, p_r, l_r, signs, p_a_re_new,
             p_a_im_new) = _polarity_combine(stw, e_s[w], p_s[w], l_s[w],
                                             ncp[w], 1)
            st1, lock, lockval, snr = _lock_snr_update(
                stw._replace(p_a_re=p_a_re_new, p_a_im=p_a_im_new),
                p_r, 1)
            logs.append(TrackLog(
                iE=e_r[:, 0], qE=e_r[:, 1], iP=p_r[:, 0], qP=p_r[:, 1],
                iL=l_r[:, 0], qL=l_r[:, 1],
                rc=rc_w[w], ri=ri_w[w],
                fc=np.float32(F_CA) + st.dfc, fi=st.fi,
                cp=st.cp, ncp=ncp[w], signs=signs, lock=lock,
                lockval=lockval, snr=snr,
                dpc=jnp.zeros_like(st.rc), dpi=jnp.zeros_like(st.rc)))
            st2 = st1._replace(cp=st.cp + ncp[w])
            st3, dpc, dpi = _loops_update(st2, e_r, p_r, l_r, fcaid,
                                          loops, 1)
            logs[-1] = logs[-1]._replace(dpc=dpc, dpi=dpi)
            st = st3
        # phase carry: frozen-rate propagation across the whole batch (the
        # correlator's own prediction), rates from the final filter state
        st = st._replace(
            rc=jnp.mod(rc_w[k - 1] + dfc0 * t_up, np.float32(L_CA)),
            ri=jnp.mod(ri_w[k - 1] + fi0 * t_up, 1.0))
        return st, jax.tree.map(lambda *xs: jnp.stack(xs), *logs)

    raw_b = raw_chunk.reshape(steps // k, k, s, 2)
    st_fin, log_b = jax.lax.scan(body, state, raw_b, unroll=int(unroll))
    log = jax.tree.map(
        lambda x: x.reshape((steps,) + x.shape[2:]), log_b)
    return st_fin, log


@functools.partial(jax.jit, static_argnames=("fs", "unroll"))
def track_open_loop(rc, dfc, ri, fi, raw_chunk, code_table, fs: float,
                    unroll: int = SCAN_UNROLL):
    """Open-loop E/P/L correlation over consecutive 1 ms windows.

    Channels are steered externally (vector tracking / EKF): no
    discriminators or loop filters run; phases propagate at the commanded
    rates. Returns per-step correlator outputs.

    rc/dfc/ri/fi: [C] float32 initial phases & rates (dfc = fc - F_CA);
    raw_chunk: [steps, S] complex or [steps, S, 2] float32.
    Parity: the correlation half of channel.scalar_correlation with the
    vt steering of receiver.vt_track (receiver.py:579-591).
    """
    if jnp.iscomplexobj(raw_chunk):
        raw_chunk = jnp.stack([jnp.real(raw_chunk), jnp.imag(raw_chunk)],
                              axis=-1).astype(jnp.float32)
    elif jnp.issubdtype(raw_chunk.dtype, jnp.integer):
        # int16 I/Q accepted directly: a quarter of the float32 upload
        raw_chunk = raw_chunk.astype(jnp.float32)
    s = raw_chunk.shape[1]
    time_idc = (jnp.arange(s) / fs).astype(jnp.float32)

    class _Carry(NamedTuple):
        rc: jax.Array
        ri: jax.Array

    def body(carry, raw):
        st = TrackState(
            rc=carry.rc, dfc=dfc, ri=carry.ri, fi=fi,
            dfc_bias=dfc, fi_bias=fi, cp=jnp.zeros_like(rc, jnp.int32),
            p_a_re=jnp.zeros_like(rc), p_a_im=jnp.zeros_like(rc),
            lf_code_h=jnp.zeros_like(rc), lf_carr_h=jnp.zeros_like(rc),
            lf_code_h2=jnp.zeros_like(rc), lf_carr_h2=jnp.zeros_like(rc),
            lock_i=jnp.zeros_like(rc), lock_q=jnp.zeros_like(rc),
            losscount=jnp.zeros_like(rc, jnp.int32),
            lockcount=jnp.zeros_like(rc, jnp.int32),
            lock=jnp.zeros_like(rc, jnp.int32),
            snr_z=jnp.zeros((rc.shape[0], SNR_N), jnp.float32),
            snr_v=jnp.zeros((rc.shape[0], SNR_N), jnp.float32),
            snr_fill=jnp.zeros_like(rc, jnp.int32),
            prev_p_re=jnp.zeros_like(rc), prev_p_im=jnp.zeros_like(rc))
        e_s, p_s, l_s, ncp = _correlate_step(st, raw[:, 0], raw[:, 1],
                                             code_table, time_idc, fs)
        e_r, p_r, l_r, signs, _, _ = _polarity_combine(st, e_s, p_s, l_s,
                                                       ncp)
        rc_new = jnp.mod(carry.rc + dfc * np.float32(T_MS), np.float32(L_CA))
        ri_new = jnp.mod(carry.ri + fi * np.float32(T_MS), 1.0)
        return _Carry(rc=rc_new, ri=ri_new), (e_r, p_r, l_r)

    _, (e, p, l) = jax.lax.scan(body, _Carry(rc=rc, ri=ri), raw_chunk,
                                unroll=int(unroll))
    return e, p, l   # each [steps, C, 2] float32 (re, im)
