"""Scalar receiver: acquisition -> tracking -> nav decode -> PVT -> handoff.

Host orchestration around the device tracking engine. The measurement logs
(per-ms channel state) live in numpy; the device does all sample-domain work
in chunked `lax.scan` calls.

Parity: reference pygnss/pythonreceiver/receiver.py (scalar_acquisition
:452-520, scalar_track :522-542, parse_ephemerides :922-932,
save_scalar_handoff :804-875) and 1_Data_reduct_scalar.py's flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import C, L_CA, T_CA
from ..libgnss import dataparser, naveng
from ..libgnss.cacode import ca_table
from ..libgnss.ephemeris import ALL_FIELDS, EphArray, Ephemeris
from ..io.handoff import Handoff, write_handoff
from ..io.rawfile import SampleFile
from ..ops import acquisition as acq_ops
from ..ops import tracking as trk_ops

LOG_FIELDS = ("iE", "qE", "iP", "qP", "iL", "qL", "rc", "ri", "fc", "fi",
              "cp", "lock", "lockval", "snr", "dpc", "dpi")


@dataclass
class ChannelLogs:
    """Per-channel measurement history (numpy, grows by chunk)."""
    prn: int
    data: dict = field(default_factory=dict)
    cp_sign: np.ndarray = field(default_factory=lambda: np.zeros(0))
    ephemeris: Ephemeris | None = None

    def append(self, **cols):
        for k, v in cols.items():
            self.data.setdefault(k, []).append(v)

    def col(self, name) -> np.ndarray:
        return np.concatenate(self.data[name]) if self.data.get(name) else np.zeros(0)


class ScalarReceiver:
    """Multi-channel scalar (DLL/PLL) receiver over a SampleFile."""

    def __init__(self, rawfile: SampleFile, prn_list,
                 loops: trk_ops.LoopConfig | None = None):
        self.rawfile = rawfile
        self.loops = loops or trk_ops.LoopConfig()
        self.prn_list = [int(p) for p in prn_list]
        self.channels = {p: ChannelLogs(prn=p) for p in self.prn_list}
        self.code_table = jnp.asarray(
            ca_table(self.prn_list).astype(np.float32))
        self.state: trk_ops.TrackState | None = None
        self.mcount = 0                  # loop updates absorbed so far
        self.coh_ms = 1                  # ms per update (set by track())
        self._m_samp: list[int] = []

    # -- acquisition -------------------------------------------------------

    def acquire(self, T: float = 0.01, verbose: bool = True,
                engine: str = "fft", deep_ms: int = 0, n_coh_ms: int = 10):
        """Best-of-two-blocks acquisition (reference receiver.py:452-520).

        engine="fft" is the complex FFT search (ops.acquisition); "real"
        the all-real circulant-matmul search (ops.acquisition_real).

        deep_ms > 0 switches to deep (weak-signal) acquisition: ONE
        deep_ms-long capture searched with n_coh_ms coherent folds summed
        noncoherently across segments (real engine only — the reference's
        10 ms best-of search, correlator.py:53-103, has no deep mode).
        E.g. deep_ms=400, n_coh_ms=10 acquires ~10 dB below the nominal
        search floor."""
        rf = self.rawfile
        s_per = int(round(T * rf.fs))
        start_pos = rf.sample_pos

        if deep_ms:
            from ..ops.acquisition_real import acquire_real as _acq
            rf.set_block(deep_ms * 1e-3, deep_ms * 1e-3, verbose=False)
            block = rf.read_block().astype(np.complex64)
            rf.seek(start_pos, whence=0)
            rf.set_block(T_CA, T_CA, verbose=False)
            results = _acq(block, self.prn_list, rf.fs, rf.fcaid,
                           n_coh_ms=n_coh_ms)
            rc = [r.rc for r in results]
            ri = [r.ri for r in results]
            fc = [r.fc for r in results]
            fi = [r.fi for r in results]
            if verbose:
                for r in results:
                    print(f"PRN {r.prn:2d} found={r.found} rc={r.rc:8.2f} "
                          f"fi={r.fi:8.1f} cppm={r.cppm:5.2f} "
                          f"(deep {deep_ms} ms / {n_coh_ms} ms coh)")
            self.state = trk_ops.init_state(rc=rc, ri=ri, fc=fc, fi=fi)
            return results

        rf.set_block(T, T, verbose=False)
        block1 = rf.read_block().astype(np.complex64)
        block2 = rf.read_block().astype(np.complex64)
        rf.seek(start_pos, whence=0)
        rf.set_block(T_CA, T_CA, verbose=False)

        if engine == "real":
            from ..ops.acquisition_real import acquire_real as _acq
        else:
            _acq = acq_ops.acquire
        res1 = _acq(block1, self.prn_list, rf.fs, rf.fcaid)
        res2 = _acq(block2, self.prn_list, rf.fs, rf.fcaid)

        rc, ri, fc, fi = [], [], [], []
        results = []
        for r1, r2 in zip(res1, res2):
            if r2.cppm > r1.cppm:
                r = r2
                rc.append(np.mod(r.rc - r.fc * T, L_CA))
                ri.append(np.mod(r.ri - r.fi * T, 1.0))
            else:
                r = r1
                rc.append(r.rc)
                ri.append(r.ri)
            fc.append(r.fc)
            fi.append(r.fi)
            results.append(r)
            if verbose:
                print(f"PRN {r.prn:2d} found={r.found} rc={rc[-1]:8.2f} "
                      f"fi={r.fi:8.1f} cppm={r.cppm:5.2f}")

        self.state = trk_ops.init_state(rc=rc, ri=ri, fc=fc, fi=fi)
        return results

    # -- tracking ----------------------------------------------------------

    def track(self, n_ms: int, chunk_ms: int = 2000, coh_ms: int = 1,
              batch_k: int = 1):
        """Track n_ms of data in device chunks, appending measurement logs.

        coh_ms > 1 enables coherent predetection integration: one loop
        update (and one measurement-log row) per coh_ms milliseconds —
        see ops.tracking.track_chunk. Log rows and `mcount` then count
        UPDATES, coh_ms ms apart (self.coh_ms records the cadence); the
        cp column stays exact (cumulative code periods), so nav solutions
        and handoffs are cadence-independent. Don't mix cadences within
        one receiver's log.

        batch_k > 1 (1 ms cadence only): k-window predictor-corrector
        batching — per-ms measurement updates with the correlation of k
        consecutive windows fused into one device pass (NCO phases lag
        the loops by <= k ms; ops.tracking.track_chunk_batched)."""
        assert self.state is not None, "acquire() (or load state) first"
        assert n_ms % coh_ms == 0, (n_ms, coh_ms)
        if batch_k > 1 and coh_ms > 1:
            raise ValueError("batch_k applies to the 1 ms cadence only")
        step_ms = coh_ms if coh_ms > 1 else batch_k
        assert n_ms % step_ms == 0, (n_ms, step_ms)
        chunk_ms -= chunk_ms % step_ms   # device chunking is internal —
        chunk_ms = max(chunk_ms, step_ms)  # round rather than reject
        self.coh_ms = coh_ms
        rf = self.rawfile
        rf.set_block(T_CA, T_CA, verbose=False)
        s = rf.S
        sw = s * coh_ms                   # samples per update window

        def read_chunk(n):
            """One chunk of n updates as [n, sw, 2] — bulk int16 slice
            (one read + the device casts on-chip; the per-block fallback
            covers duty-cycled/exotic configs): no per-ms Python loop and
            a quarter of the float32 upload."""
            try:
                return rf.read_chunk_raw(n * coh_ms).reshape(n, sw, 2)
            except (AttributeError, ValueError):
                raw = np.empty((n, sw, 2), dtype=np.float32)
                for i in range(n * coh_ms):
                    blk = rf.read_block()
                    u, o = divmod(i, coh_ms)
                    raw[u, o * s:(o + 1) * s, 0] = blk.real
                    raw[u, o * s:(o + 1) * s, 1] = blk.imag
                return raw

        # double-buffered uploads on a staging thread: the GIL releases
        # during the transfer, so a one-thread executor overlaps chunk
        # k+1's read+upload with chunk k's device scan + log fetch
        from concurrent.futures import ThreadPoolExecutor

        def stage(n):
            start = rf.sample_pos
            return n, start, jax.device_put(read_chunk(n))

        done = 0
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(stage, min(chunk_ms, n_ms - done) // coh_ms)
            while fut is not None:
                n, start_samp, raw_dev = fut.result()
                done += n * coh_ms
                fut = (pool.submit(stage,
                                   min(chunk_ms, n_ms - done) // coh_ms)
                       if done < n_ms else None)
                if batch_k > 1:
                    self.state, log = trk_ops.track_chunk_batched(
                        self.state, raw_dev, self.code_table, rf.fs,
                        rf.fcaid, self.loops, batch_k=batch_k)
                else:
                    self.state, log = trk_ops.track_chunk(
                        self.state, raw_dev, self.code_table, rf.fs,
                        rf.fcaid, self.loops, coh_ms=coh_ms)
                self._absorb_log(log)
                self._m_samp.extend(start_samp + (np.arange(n) + 1) * sw)
                self.mcount += n

    def _absorb_log(self, log):
        # TWO packed device->host fetches for the whole log (floats+signs,
        # and the integer counters at full int32 exactness — cp is a
        # cumulative code-period count that outgrows f32-exact integers
        # after ~4.6 h): device-side stacks make it two transfers instead
        # of one per field.
        kmax = int(log.signs.shape[2])
        f_fields = [k for k in LOG_FIELDS if k != "cp"]
        packed = np.asarray(jnp.concatenate(
            [jnp.stack([getattr(log, k).astype(jnp.float32)
                        for k in f_fields]),
             jnp.moveaxis(log.signs, 2, 0).astype(jnp.float32)], axis=0))
        ints = np.asarray(jnp.stack([log.cp.astype(jnp.int32),
                                     log.ncp.astype(jnp.int32)]))
        arrs = {k: packed[i] for i, k in enumerate(f_fields)}
        arrs["cp"] = ints[0]
        n = len(f_fields)
        ncp = ints[1]                       # [steps, C]
        signs = np.moveaxis(packed[n:n + kmax], 0, 2)
        # expand completed-code-period signs into the cp_sign streams with
        # one boolean mask per channel (row-major flattening preserves the
        # (step ascending, k ascending) order of the per-period stream);
        # the per-step python loop this replaces cost ~0.5 s per 2 s chunk
        k_arange = np.arange(kmax)[None, :]
        for ci, prn in enumerate(self.prn_list):
            ch = self.channels[prn]
            ch.append(**{k: arrs[k][:, ci] for k in LOG_FIELDS})
            take = k_arange < np.minimum(ncp[:, ci], kmax)[:, None]
            if take.any():
                ch.cp_sign = np.concatenate([ch.cp_sign,
                                             signs[:, ci, :][take]])

    # -- navigation --------------------------------------------------------

    def decode_ephemerides(self, verbose: bool = True):
        """Frame + decode LNAV for each channel from its cp_sign stream."""
        good = []
        for prn in self.prn_list:
            ch = self.channels[prn]
            try:
                eph, parity_ok = dataparser.parse_ephemerides(
                    ch.cp_sign, cp_offset=0.0, prn=prn)
                ch.ephemeris = eph
                good.append(prn)
                if verbose:
                    print(f"PRN {prn:2d}: TOW {eph.tow_timestamp:.0f} at cp "
                          f"{eph.cp_timestamp:.0f}, parity {parity_ok}/50, "
                          f"complete={eph.complete}")
            except ValueError as e:
                if verbose:
                    print(f"PRN {prn:2d}: decode failed: {e}")
        return good

    def set_ephemerides(self, eph_by_prn: dict[int, Ephemeris]):
        for prn, eph in eph_by_prn.items():
            if prn in self.channels:
                self.channels[prn].ephemeris = eph

    def eph_array(self, prns=None) -> EphArray:
        prns = prns if prns is not None else self.prn_list
        return EphArray([self.channels[p].ephemeris for p in prns])

    def observables(self, mc: int | None = None):
        """(cp, rc, fi) per channel at measurement index mc (default last)."""
        mc = (self.mcount - 1) if mc is None else mc
        cp = np.array([self.channels[p].col("cp")[mc] for p in self.prn_list],
                      dtype=np.float64)
        rc = np.array([self.channels[p].col("rc")[mc] for p in self.prn_list])
        fi = np.array([self.channels[p].col("fi")[mc] for p in self.prn_list])
        return cp, rc, fi

    def nav_solution(self, mc: int | None = None, rx_time0=None, rx_pos0=None):
        cp, rc, fi = self.observables(mc)
        return naveng.calculate_nav_soln(cp, rc, fi, self.eph_array(),
                                         doppler_sign=self.rawfile.ds,
                                         rx_time0=rx_time0, rx_pos0=rx_pos0)

    # -- handoff -----------------------------------------------------------

    def save_handoff(self, path: str, mc: int | None = None) -> Handoff:
        """Export the DPE-initialization checkpoint at measurement mc.

        Contract (io/scenario.py, DPEReceiver.__init__): rx_time and the
        channel state describe the epoch of the sample at bytes_read.
        Log row mc holds the state at the START of window mc while
        _m_samp[mc] is the window's END, so the exported state is
        propagated across the window (coh_ms ms) at the tracked rates —
        at 1 ms cadence the skew is sub-chip and was absorbed by the
        clock estimate; at coh_ms=8 it would be 8 code periods of cp and
        ~30 m of satellite motion, so the propagation is exact, not
        cosmetic."""
        mc = (self.mcount - 1) if mc is None else mc
        rx_time_a, rx_time, x_ecef, _, _ = self.nav_solution(mc)
        dt = self.coh_ms * 1e-3          # window span of log row mc

        h = Handoff()
        h.rx_time = float(rx_time) + dt
        h.rx_time_a = float(rx_time_a) + dt
        h.x_ecef = np.asarray(x_ecef).ravel()
        h.x_ecef[0:3] += h.x_ecef[4:7] * dt
        h.x_ecef[3] += h.x_ecef[7] * dt
        h.bytes_read = int(self._m_samp[mc] * self.rawfile.datatype.itemsize)
        h.prn_list = list(self.prn_list)
        for name in ("rc", "ri", "fc", "fi", "cp"):
            setattr(h, name, np.array(
                [self.channels[p].col(name)[mc] for p in self.prn_list],
                dtype=np.float64))
        adv = h.rc + h.fc * dt           # code phase across the window
        h.cp = h.cp + np.floor(adv / L_CA)
        h.rc = np.mod(adv, L_CA)
        h.ri = np.mod(h.ri + h.fi * dt, 1.0)
        h.cp_timestamp = np.array(
            [self.channels[p].ephemeris.cp_timestamp for p in self.prn_list])
        h.tow = np.array(
            [self.channels[p].ephemeris.tow_timestamp for p in self.prn_list])
        for name in ALL_FIELDS + ("IODE", "IODC"):
            h.eph_fields[name] = np.array(
                [getattr(self.channels[p].ephemeris, name)
                 for p in self.prn_list], dtype=np.float64)
        if path:
            write_handoff(path, h)
        return h

    # -- checkpoint / resume ----------------------------------------------

    def save_state(self, dirname: str):
        """Full receiver checkpoint: measurement logs + tracking carry.

        Unlike the reference (.mat logs that drop loop-filter history,
        receiver.py:880-882), the complete TrackState is saved so resumed
        tracking is bit-identical.
        """
        import os
        import scipy.io as sio

        os.makedirs(dirname, exist_ok=True)
        rec = {
            "prn_list": np.array(self.prn_list),
            "mcount": self.mcount,
            "m_samp": np.array(self._m_samp, dtype=np.int64),
            "fs": self.rawfile.fs,
            "sample_pos": self.rawfile.sample_pos,
        }
        if self.state is not None:
            for name, val in self.state._asdict().items():
                rec["state_" + name] = np.asarray(val)
        sio.savemat(os.path.join(dirname, "receiver.mat"), rec)

        for prn in self.prn_list:
            ch = self.channels[prn]
            d = {"log_" + k: ch.col(k) for k in LOG_FIELDS}
            d["cp_sign"] = ch.cp_sign
            if ch.ephemeris is not None:
                for fld in ALL_FIELDS + ("IODE", "IODC", "tow_timestamp",
                                         "cp_timestamp"):
                    d["eph_" + fld] = getattr(ch.ephemeris, fld)
            sio.savemat(os.path.join(dirname, f"channel_{prn}.mat"), d)

    def load_state(self, dirname: str):
        """Restore a checkpoint written by save_state and reposition the
        sample file so tracking resumes at the exact next block."""
        import os
        import scipy.io as sio

        from ..libgnss.ephemeris import Ephemeris
        from ..ops.tracking import TrackState

        rec = sio.loadmat(os.path.join(dirname, "receiver.mat"))
        assert list(rec["prn_list"].ravel()) == self.prn_list
        self.mcount = int(rec["mcount"].ravel()[0])
        self._m_samp = list(rec["m_samp"].ravel())
        self.rawfile.seek(int(rec["sample_pos"].ravel()[0]), whence=0)

        import jax.numpy as jnp
        fields = {}
        for name in TrackState._fields:
            fields[name] = jnp.asarray(rec["state_" + name])
        self.state = TrackState(**fields)

        for prn in self.prn_list:
            d = sio.loadmat(os.path.join(dirname, f"channel_{prn}.mat"))
            ch = self.channels[prn]
            ch.data = {k: [d["log_" + k].ravel()] for k in LOG_FIELDS}
            ch.cp_sign = d["cp_sign"].ravel()
            if "eph_sqrt_A" in d:
                e = Ephemeris(prn=prn)
                for fld in ALL_FIELDS + ("tow_timestamp", "cp_timestamp"):
                    setattr(e, fld, float(d["eph_" + fld].ravel()[0]))
                e.IODE = int(d["eph_IODE"].ravel()[0])
                e.IODC = int(d["eph_IODC"].ravel()[0])
                e.complete = True
                ch.ephemeris = e

    def get_nms_correlation(self, prn: int, ms: int, n: int):
        """Bit-synchronized E/P/L sums over the last n 1 ms correlations
        ending at measurement ms: segments between nav-bit boundaries are
        sign-aligned before use (reference channel.get_Nms_correlation,
        channel.py:344-422).

        Returns (iE, iP, iL, qE, qP, qL) arrays of length n with polarity
        unified across bit boundaries.
        """
        ch = self.channels[prn]
        if ch.ephemeris is None:
            raise ValueError("ephemeris anchor (cp_timestamp) required")
        cp = ch.col("cp")[ms - n:ms]
        cp_idc = np.mod(cp - ch.ephemeris.cp_timestamp, 20)
        bd_idc = np.where(np.diff(cp_idc) < 0)[0]
        assert len(bd_idc) <= 2, f"{len(bd_idc)} bit boundaries in {n} ms"

        cols = {k: ch.col(k)[ms - n:ms].copy()
                for k in ("iE", "iP", "iL", "qE", "qP", "qL")}
        combined = (cols["iE"] + cols["iP"] + cols["iL"]
                    + 1j * (cols["qE"] + cols["qP"] + cols["qL"]))

        bounds = [0] + [int(b) + 1 for b in bd_idc] + [n]
        ref_sum = np.sum(combined[bounds[0]:bounds[1]])
        for k in range(1, len(bounds) - 1):
            seg = slice(bounds[k], bounds[k + 1])
            seg_sum = np.sum(combined[seg])
            if abs(ref_sum + seg_sum) < abs(ref_sum - seg_sum):
                for name in cols:
                    cols[name][seg] = -cols[name][seg]
                seg_sum = -seg_sum
            ref_sum = ref_sum + seg_sum
        return (cols["iE"], cols["iP"], cols["iL"],
                cols["qE"], cols["qP"], cols["qL"])
