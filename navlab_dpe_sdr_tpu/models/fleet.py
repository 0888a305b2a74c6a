"""Multi-receiver data-parallel processing with time alignment.

The reference processes one capture file per USRP front-end with a Python
thread per receiver, then aligns their receive clocks by tracking extra
1 ms blocks on the laggards before DPE (0_Data_reduction.py:32-133,
1_Data_reduct_scalar.py:35-108). Same structure here: a fleet of
ScalarReceivers (threaded), millisecond-quantized alignment via each
receiver's navigation solution, then per-receiver DPE loops with periodic
checkpoints.
"""

from __future__ import annotations

import threading

import numpy as np


class ReceiverFleet:
    """Run N receivers over N capture files in parallel threads."""

    def __init__(self, rawfiles, prn_list, labels=None):
        from .scalar import ScalarReceiver

        self.receivers = [ScalarReceiver(rf, prn_list) for rf in rawfiles]
        self.labels = labels or [f"rx{i}" for i in range(len(rawfiles))]
        self.multi = None                 # set by from_live

    @classmethod
    def from_live(cls, multi, prn_list, fs: float, max_seconds: float,
                  labels=None, timeout_s: float = 10.0,
                  miss_budget_s: float = 2.0):
        """Fleet over a live synchronized radio group (io.frontend
        MultiSource): one LiveSampleFile per radio, pumped on its own
        thread, so the whole acquire -> track -> decode -> align -> DPE
        flow runs against live-paced delivery — the reference's
        multi-USRP capture + per-file processing (guhd.cpp:27-60,
        0_Data_reduction.py:32-133) collapsed into one live path."""
        from ..io.frontend import LiveSampleFile

        multi.start()
        # miss budget default = one 2 s tracking chunk: a miss means the
        # consumer fell a full chunk behind, i.e. a real radio's bounded
        # ring buffer (guhd FileBuff) would be overflowing; sub-chunk
        # transients are normal pipelining (lag_max_s still records them)
        raws = [LiveSampleFile(src, fs=fs, max_seconds=max_seconds,
                               timeout_s=timeout_s,
                               miss_budget_s=miss_budget_s)
                for src in multi.sources]
        fleet = cls(raws, prn_list, labels)
        fleet.multi = multi
        return fleet

    def mark_phase(self, name: str):
        """Close a live phase on every receiver (LiveSampleFile
        phase_mark): per-phase lag accounting, since state transitions
        (decode, handoff) legitimately pause consumption."""
        for rx in self.receivers:
            if hasattr(rx.rawfile, "phase_mark"):
                rx.rawfile.phase_mark(name)

    def live_stats(self):
        """Per-receiver live delivery/consumption stats (from_live only):
        zero track-phase lag_misses means every consumer held the antenna
        pace through tracking; the dpe phase's lag_last <= lag_max shows
        it caught up from the decode pause rather than losing ground."""
        out = []
        for label, rx in zip(self.labels, self.receivers):
            rf = rx.rawfile
            out.append({
                "label": label,
                "lag_max_s": round(getattr(rf, "lag_max_s", 0.0), 4),
                "lag_misses": int(getattr(rf, "lag_misses", 0)),
                "phases": getattr(rf, "phases", {}),
                "delivered_s": round(
                    getattr(rf, "_delivered", 0) / rf.fs, 3)})
        return out

    def _parallel(self, fn):
        """Run fn(rx) on every receiver concurrently; re-raise the first
        failure after all threads join."""
        errors = []

        def wrap(rx):
            try:
                fn(rx)
            except Exception as e:   # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=wrap, args=(rx,))
                   for rx in self.receivers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def acquire(self, verbose: bool = False):
        self._parallel(lambda rx: rx.acquire(verbose=verbose))

    def track(self, n_ms: int, parallel: bool = True):
        if parallel:
            self._parallel(lambda rx: rx.track(n_ms))
        else:
            for rx in self.receivers:
                rx.track(n_ms)

    def decode_ephemerides(self, verbose: bool = False):
        return [rx.decode_ephemerides(verbose=verbose)
                for rx in self.receivers]

    def align(self, chunk_ms: int = 1) -> np.ndarray:
        """Track extra 1 ms blocks on laggards so all receivers' estimated
        receive times agree to the millisecond (0_Data_reduction.py:124-133).

        chunk_ms=1 tracks the catch-up milliseconds one device chunk at a
        time: the offset is data-dependent, and a [off, S, 2] chunk would
        be a fresh jit signature compiled mid-run — fatal under live
        pacing where first executions cost seconds (the [1, S, 2]
        signature is pre-warmable). Returns the per-receiver offsets
        applied (ms)."""
        times = []
        for rx in self.receivers:
            rx_time_a, *_ = rx.nav_solution()
            times.append(rx_time_a)
        times = np.array(times)
        offsets = np.round((times.max() - times) * 1000.0).astype(int)
        for rx, off in zip(self.receivers, offsets):
            if off > 0:
                rx.track(int(off), chunk_ms=chunk_ms)
        return offsets

    def nav_solutions(self):
        return [rx.nav_solution() for rx in self.receivers]

    def run_dpe(self, n_blocks: int, grid=None, config=None,
                checkpoint_every: int = 100, checkpoint_dir=None,
                parallel: bool = True, lookahead: int = 1):
        """Per-receiver DPE loops (handoff taken from each receiver's own
        state), with periodic fix-array checkpoints
        (0_Data_reduction.py:175-179).

        lookahead > 1 runs each receiver in batched mode (run_batched,
        K blocks per device dispatch), amortizing the fixed per-dispatch
        cost over K blocks (the same reason cli live batches)."""
        from .dpe import DPEReceiver
        from .grid import spread_grid

        dpe_rxs = []
        for i, rx in enumerate(self.receivers):
            hand = rx.save_handoff(path=None)
            rx.rawfile.seek_bytes(hand.bytes_read)
            dpe_rxs.append(DPEReceiver(rx.rawfile, hand,
                                       grid=grid or spread_grid(),
                                       config=config))

        def run_one(idx_rx):
            idx, drx = idx_rx
            if lookahead > 1:
                k = min(lookahead, n_blocks)     # never round down to zero
                n = n_blocks - n_blocks % k
                if n != n_blocks:
                    print(f"fleet dpe: trimming {n_blocks - n} blocks to "
                          f"whole {k}-block dispatches")
                done = 0
                # honor the periodic-checkpoint contract in batched mode
                # too (0_Data_reduction.py:175-179): save every
                # checkpoint_every blocks rounded to whole dispatches
                seg = max(k, checkpoint_every - checkpoint_every % k)
                while done < n:
                    step_n = min(seg, n - done)
                    drx.run_batched(step_n, lookahead=k, pipeline=True)
                    done += step_n
                    if checkpoint_dir:
                        np.save(
                            f"{checkpoint_dir}/{self.labels[idx]}_X.npy",
                            np.stack([f.x_ecef for f in drx.fixes]))
                return
            for b in range(n_blocks):
                drx.step()
                if checkpoint_dir and (b + 1) % checkpoint_every == 0:
                    np.save(f"{checkpoint_dir}/{self.labels[idx]}_X.npy",
                            np.stack([f.x_ecef for f in drx.fixes]))

        if parallel:
            threads = [threading.Thread(target=run_one, args=((i, d),))
                       for i, d in enumerate(dpe_rxs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for i, d in enumerate(dpe_rxs):
                run_one((i, d))
        return dpe_rxs
