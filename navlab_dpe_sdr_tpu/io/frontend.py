"""RF front-end subsystem: unified sample sources, rotating capture
recorder, and radio drivers.

Reference: cudarecv/guhd — multi-USRP clock/sync/tuning config
(guhd.cpp:27-60), timestamped 10-minute rotating capture files
(buffer.cpp:47-78: ``YYYYMMDD_HHMMSS_usrpN_rateKHz.dat``), and the
module-ified live source (streamblock.cu:27-79). The test and build hosts
have no RF hardware, so the subsystem is interface-first:

- ``SampleSource``: the protocol every source implements — file, TCP,
  simulated radio, SoapySDR/UHD hardware. ``next_block() -> [S, 2] int16``
  (None on clean end), ``fs``, context-manager close.
- ``FileSource``: capture-file blocks (offline replay).
- ``SimulatedRadio``: wall-clock-paced in-process source over a backing
  sample array or capture file — the CI-testable driver that proves the
  interface under the live flow (the role guhd's streamblock plays on
  hardware).
- ``RotatingRecorder``: guhd's capture contract — timestamped filenames,
  10-minute rotation (buffer.cpp:47-78).
- ``SoapyRadio``: import-guarded SoapySDR binding (L1 front-end defaults
  from guhd.cpp: 1575.42 MHz, 50 dB gain). Exercised only where the
  library + hardware exist; everything above it is hardware-independent.
- ``open_source``/``record``: URL-style constructor + source->recorder
  pump (the ``cli record`` subcommand).
"""

from __future__ import annotations

import os
import time

import numpy as np

from .rawfile import DTYPE_IQ16, SampleFile

F_L1_HZ = 1575.42e6      # GPS L1 center (guhd.cpp L1 tuning)
F_L2_HZ = 1227.60e6      # GPS L2 center (guhd.cpp ltwo channels)
DEFAULT_GAIN_DB = 50.0   # guhd.cpp gain default


class SampleSource:
    """Protocol base for block sample sources.

    Concrete sources deliver interleaved int16 I/Q as [block_samples, 2]
    arrays. ``next_block`` returns None on clean end-of-stream and raises
    TimeoutError when a live source stalls past its watchdog (the
    reference's 1.5 s fail-fast, sampleblock.cu:432-447).
    """

    fs: float
    block_samples: int

    def next_block(self) -> np.ndarray | None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileSource(SampleSource):
    """Capture-file block source (offline replay / recorder input)."""

    def __init__(self, path: str, fs: float, block_samples: int,
                 start_byte: int = 0):
        self.fs = float(fs)
        self.block_samples = int(block_samples)
        self._fo = open(path, "rb")
        if start_byte:
            self._fo.seek(start_byte)

    def next_block(self):
        want = self.block_samples * 4
        buf = self._fo.read(want)
        if len(buf) < want:
            return None
        return np.frombuffer(buf, np.int16).reshape(self.block_samples, 2)

    def close(self):
        self._fo.close()


class SimulatedRadio(SampleSource):
    """Wall-clock-paced radio driver over a backing sample array.

    Delivers each block no earlier than its air time (block end at
    ``start + (delivered_samples / fs)`` on the host clock), exactly the
    delivery contract of a streaming front-end (streamblock.cu:27-79 /
    RunLive, sampleblock.cu:421-426) — but in-process and CI-testable.
    ``behind_max_s`` records how far the consumer let delivery slip past
    air time (a consumer that keeps up shows ~0; the socket-backpressure
    analogue of PacedReplayServer.behind_max_s).

    samples: int16 structured/plain array or a capture path; loop=True
    wraps around (an antenna never stops); realtime=False removes the
    pacing (as-fast-as-possible, for recorder tests).
    """

    def __init__(self, samples, fs: float, block_samples: int,
                 loop: bool = False, realtime: bool = True,
                 start_byte: int = 0):
        if isinstance(samples, (str, os.PathLike)):
            samples = np.fromfile(samples, np.int16)
        samples = np.asarray(samples)
        if samples.dtype != np.int16:     # structured DTYPE_IQ16 etc.
            samples = samples.view(np.int16)
        self._iq = samples.reshape(-1, 2)[start_byte // 4:]
        self.fs = float(fs)
        self.block_samples = int(block_samples)
        self.loop = loop
        self.realtime = realtime
        self.behind_max_s = 0.0
        self.blocks_delivered = 0
        self._pos = 0
        self._t0 = None

    def next_block(self):
        n, s = self._iq.shape[0], self.block_samples
        if self._pos + s > n:
            if not self.loop or s > n:
                return None
            self._pos = 0        # wrap: restart the capture (tail dropped)
        blk = self._iq[self._pos:self._pos + s]
        self._pos += s
        self.blocks_delivered += 1
        if self.realtime:
            if self._t0 is None:
                self._t0 = time.perf_counter()
            air = self._t0 + self.blocks_delivered * s / self.fs
            now = time.perf_counter()
            if now < air:
                time.sleep(air - now)
            else:
                self.behind_max_s = max(self.behind_max_s, now - air)
        return blk


class RotatingRecorder:
    """Timestamped rotating capture writer (guhd buffer.cpp:47-78).

    Files are named ``YYYYMMDD_HHMMSS_usrpN_rateKHz.dat`` from the local
    time at file open, and a new file starts every ``rotate_s`` seconds of
    SIGNAL time (sample count / fs — the reference rotates on its sample
    clock too, so gaps in wall time never split a file). Default rotation
    10 minutes, as the reference.
    """

    def __init__(self, out_dir: str, fs: float, usrp_index: int = 0,
                 rotate_s: float = 600.0, clock=time.localtime):
        self.out_dir = out_dir
        self.fs = float(fs)
        self.usrp_index = int(usrp_index)
        self.rotate_s = float(rotate_s)
        self._clock = clock
        self.files: list[str] = []
        self._fo = None
        self._samples_in_file = 0
        os.makedirs(out_dir, exist_ok=True)

    def _open_new(self):
        if self._fo is not None:
            self._fo.close()
        stamp = time.strftime("%Y%m%d_%H%M%S", self._clock())
        rate_khz = int(round(self.fs / 1e3))
        name = f"{stamp}_usrp{self.usrp_index}_{rate_khz}KHz.dat"
        path = os.path.join(self.out_dir, name)
        # the reference rotates at 10 min so its 1 s timestamp resolution
        # never collides; sub-second rotations (tests, bursty captures)
        # get a dedup suffix rather than silently overwriting
        k = 1
        while path in self.files or os.path.exists(path):
            path = os.path.join(self.out_dir,
                                name.replace(".dat", f"_{k}.dat"))
            k += 1
        self._fo = open(path, "wb")
        self.files.append(path)
        self._samples_in_file = 0

    def write(self, block: np.ndarray):
        """Append one [S, 2] (or flat interleaved) int16 block."""
        if self._fo is None or \
                self._samples_in_file / self.fs >= self.rotate_s:
            self._open_new()
        arr = np.ascontiguousarray(block, dtype=np.int16)
        self._fo.write(arr.tobytes())
        self._samples_in_file += arr.size // 2

    def close(self):
        if self._fo is not None:
            self._fo.close()
            self._fo = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SoapyRadio(SampleSource):
    """SoapySDR hardware front-end (import-guarded; L1 defaults per
    guhd.cpp:27-60: center 1575.42 MHz, 50 dB gain, external clock
    optional). Streams CS16 into [S, 2] int16 blocks.

    Untestable in CI (no RF hardware / SoapySDR there); the class
    exists so a hardware deployment only swaps the constructor — every
    consumer (record pump, live flow, DPE receiver) sees SampleSource.
    """

    def __init__(self, driver_args: str, fs: float, block_samples: int,
                 center_hz: float = F_L1_HZ, gain_db: float = DEFAULT_GAIN_DB,
                 clock_source: str | None = None, channel: int = 0,
                 timeout_s: float = 1.5):
        try:
            import SoapySDR
            from SoapySDR import SOAPY_SDR_CS16, SOAPY_SDR_RX
        except ImportError as e:                      # pragma: no cover
            raise RuntimeError(
                "SoapySDR python bindings not installed; SoapyRadio needs "
                "a radio-equipped host (CI uses SimulatedRadio)") from e
        self.fs = float(fs)
        self.block_samples = int(block_samples)
        self._timeout_us = int(timeout_s * 1e6)
        self._dev = SoapySDR.Device(driver_args)      # pragma: no cover
        if clock_source:                              # pragma: no cover
            self._dev.setClockSource(clock_source)    # guhd external 10 MHz
        self._dev.setSampleRate(SOAPY_SDR_RX, channel, self.fs)
        self._dev.setFrequency(SOAPY_SDR_RX, channel, center_hz)
        self._dev.setGain(SOAPY_SDR_RX, channel, gain_db)
        self._stream = self._dev.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CS16,
                                             [channel])
        self._dev.activateStream(self._stream)
        self._buf = np.empty(self.block_samples * 2, np.int16)

    def apply_sync(self, sync, index: int = 0,
                   epoch: float | None = None):       # pragma: no cover
        """Apply a MultiSource RadioSyncConfig to this device: clock
        source, PPS time discipline (set_time_unknown_pps(0) + 1 s wait,
        guhd.cpp:230-233), MIMO slaving (this board's clock AND time ride
        the MIMO cable when it is the configured slave, guhd.cpp:219-225),
        and arm the stream at a shared future hardware time
        (stream_cmd.time_spec = now + setup_time, guhd.cpp:126-130).
        Hardware-only; unexercised in CI."""
        del epoch                                     # host epoch n/a here
        from SoapySDR import SOAPY_SDR_RX
        if index in sync.l2_channels:                 # guhd ltwo option
            self._dev.setFrequency(SOAPY_SDR_RX, 0, F_L2_HZ)
        if sync.mimo_slave is not None and index == sync.mimo_slave:
            self._dev.setClockSource("mimo")
            self._dev.setTimeSource("mimo")
        else:
            self._dev.setClockSource(sync.clock_source)
            if sync.pps_sync:
                self._dev.setTimeSource("external")
                self._dev.setHardwareTime(0, "PPS")
                time.sleep(1.0)                       # wait one PPS edge
        # re-arm the stream at a shared future device time
        try:
            self._dev.deactivateStream(self._stream)
            t_start = self._dev.getHardwareTime() + int(
                sync.setup_time_s * 1e9)
            self._dev.activateStream(self._stream, 0, t_start)
        except Exception:
            self._dev.activateStream(self._stream)

    def next_block(self):                             # pragma: no cover
        got = 0
        while got < self.block_samples:
            view = self._buf[2 * got:]
            sr = self._dev.readStream(self._stream, [view],
                                      self.block_samples - got,
                                      timeoutUs=self._timeout_us)
            if sr.ret == 0 or getattr(sr, "flags", 0) < 0:
                raise TimeoutError("radio stream stalled")
            if sr.ret < 0:
                raise RuntimeError(f"readStream error {sr.ret}")
            got += sr.ret
        return self._buf.reshape(self.block_samples, 2)

    def close(self):                                  # pragma: no cover
        try:
            self._dev.deactivateStream(self._stream)
            self._dev.closeStream(self._stream)
        except Exception:
            pass


def open_source(url: str, fs: float, block_samples: int,
                start_byte: int = 0, timeout_s: float = 1.5,
                loop: bool = False) -> SampleSource:
    """URL-style source constructor unifying every front-end:

    - ``path/to/capture.dat``      -> FileSource
    - ``sim://path/to/capture.dat``-> SimulatedRadio (wall-clock paced)
    - ``tcp://host:port``          -> TCP sample stream (netsource)
    - ``soapy://driver=...``       -> SoapyRadio hardware (when present)
    """
    if url.startswith("sim://"):
        return SimulatedRadio(url[6:], fs, block_samples, loop=loop,
                              start_byte=start_byte)
    if url.startswith("tcp://"):
        from .netsource import open_tcp_source
        host, port = url[6:].rsplit(":", 1)
        return open_tcp_source(host, int(port), block_samples,
                               timeout_s=timeout_s, start_byte=start_byte)
    if url.startswith("soapy://"):
        return SoapyRadio(url[8:], fs, block_samples,
                          timeout_s=timeout_s)
    return FileSource(url, fs, block_samples, start_byte=start_byte)


def record(source: SampleSource, recorder: RotatingRecorder,
           seconds: float | None = None, on_block=None) -> int:
    """Pump a source into the rotating recorder (the guhd main loop,
    guhd.cpp + buffer.cpp). Returns blocks written. ``on_block`` is an
    optional per-block callback (progress / live fan-out)."""
    n_blocks = (int(round(seconds * source.fs / source.block_samples))
                if seconds is not None else None)
    done = 0
    while n_blocks is None or done < n_blocks:
        blk = source.next_block()
        if blk is None:
            break
        recorder.write(blk)
        done += 1
        if on_block is not None:
            on_block(done, blk)
    return done


# ---------------------------------------------------------------------------
# Multi-radio synchronized capture (guhd.cpp:27-60, 218-235 + the fleet
# alignment flow 0_Data_reduction.py:32-90, 124-133)
# ---------------------------------------------------------------------------

class RadioSyncConfig:
    """Shared-clock configuration surface for N synchronized radios.

    Mirrors guhd's multi-USRP parameters (guhd.cpp:27-60, set_clock
    218-235): ``clock_source`` ('internal' | 'external' | 'gpsdo' |
    'mimo'), ``pps_sync`` (discipline device time to the next external
    PPS edge, set_time_unknown_pps(0) + 1 s wait), ``mimo_slave``
    (board index slaved over the MIMO cable: its clock AND time sources
    become 'mimo'), and ``setup_time_s`` (all streams start at a shared
    device-time point this far in the future — guhd's SETUP_TIME
    stream_cmd). ``l2_channels`` lists channel indices tuned to L2
    (1227.60 MHz) instead of L1, guhd's ``ltwo`` option.
    """

    def __init__(self, clock_source: str = "internal",
                 pps_sync: bool = False, mimo_slave: int | None = None,
                 setup_time_s: float = 1.5,
                 l2_channels: tuple[int, ...] = ()):
        self.clock_source = clock_source
        self.pps_sync = pps_sync
        self.mimo_slave = mimo_slave
        self.setup_time_s = float(setup_time_s)
        self.l2_channels = tuple(l2_channels)


class MultiSource:
    """N radios on one clock: lifecycle + sync config for a source group.

    For hardware members (SoapyRadio) ``start()`` applies the
    RadioSyncConfig per device (clock source, PPS discipline, slaved
    MIMO boards) and arms every stream at the same future hardware time;
    for simulated members it anchors all pacing clocks to ONE shared
    host-clock epoch ``setup_time_s`` ahead — the same contract, so the
    fleet composition is testable without RF hardware. Iterate
    ``sources`` (each keeps its own per-channel delivery state) or call
    ``next_blocks()`` for lockstep one-block-per-radio delivery
    (guhd's single multi-channel recv, guhd.cpp:142-147).
    """

    def __init__(self, sources, sync: RadioSyncConfig | None = None):
        self.sources = list(sources)
        self.sync = sync or RadioSyncConfig()
        self._started = False

    def start(self):
        if self._started:
            return self
        epoch = time.perf_counter() + self.sync.setup_time_s
        for i, src in enumerate(self.sources):
            if isinstance(src, SimulatedRadio):
                src._t0 = epoch
            elif hasattr(src, "apply_sync"):      # pragma: no cover
                src.apply_sync(self.sync, index=i, epoch=epoch)
        self._started = True
        return self

    def next_blocks(self):
        """One lockstep block per radio; None once ANY stream ends (the
        synchronized group is only useful while all channels deliver)."""
        if not self._started:
            self.start()
        blks = [src.next_block() for src in self.sources]
        if any(b is None for b in blks):
            return None
        return blks

    @property
    def behind_max_s(self) -> float:
        return max((getattr(s, "behind_max_s", 0.0) for s in self.sources),
                   default=0.0)

    def close(self):
        for s in self.sources:
            s.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


class LiveSampleFile(SampleFile):
    """Random-access ``SampleFile`` facade over a forward-only live source.

    The scalar and DPE receivers consume the rawfile protocol
    (read_block / seek / sample_pos); a radio only streams forward. A
    pump thread appends arriving blocks to a preallocated capture
    buffer and readers BLOCK until their window has been delivered —
    the real-time contract: a consumer faster than the antenna waits
    (delivery, not work), one slower falls behind, which is recorded
    (``lag_max_s``, ``lag_misses``) rather than hidden. This collapses
    the reference's record-then-process flow (guhd FileBuff,
    buffer.cpp:47-78, then 0_Data_reduction.py per-file threads) into
    one live path while keeping its semantics.
    """

    def __init__(self, source: SampleSource, fs: float,
                 max_seconds: float, ds: float = 1.0,
                 timeout_s: float = 10.0, miss_budget_s: float = 0.2):
        import threading

        cap = int(round(max_seconds * fs))
        super().__init__(samples=np.zeros(cap, DTYPE_IQ16), fs=fs, ds=ds)
        self._src = source
        self._delivered = 0
        self._done = False
        self._cv = threading.Condition()
        self.timeout_s = float(timeout_s)
        self.miss_budget_s = float(miss_budget_s)
        self.lag_max_s = 0.0
        self.lag_last_s = 0.0
        self.lag_misses = 0
        self.phases: dict[str, dict] = {}
        self._pump = threading.Thread(target=self._run, daemon=True)
        self._pump.start()

    def _run(self):
        cap = self._raw.shape[0]
        while True:
            try:
                blk = self._src.next_block()
            except Exception:
                blk = None
            with self._cv:
                if blk is None or self._delivered + blk.shape[0] > cap:
                    self._done = True
                    self._cv.notify_all()
                    return
                n = blk.shape[0]
                self._raw["i"][self._delivered:self._delivered + n] = blk[:, 0]
                self._raw["q"][self._delivered:self._delivered + n] = blk[:, 1]
                self._delivered += n
                self._cv.notify_all()

    @property
    def n_samples(self) -> int:
        # readers see only delivered samples; SampleFile's EOF checks then
        # apply to the LIVE edge, not the buffer capacity
        return self._delivered

    def _wait_for(self, n: int):
        # STALL timeout, not a total-wait deadline: a healthy real-time
        # source delivering a large future window takes window-seconds of
        # wall time by definition; the timeout only fires if delivery
        # makes NO progress for timeout_s (the watchdog contract)
        with self._cv:
            deadline = time.perf_counter() + self.timeout_s
            seen = self._delivered
            while self._delivered < n and not self._done:
                if self._delivered > seen:
                    seen = self._delivered
                    deadline = time.perf_counter() + self.timeout_s
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError(
                        f"live source stalled: no delivery for "
                        f"{self.timeout_s} s (need {n} samples, "
                        f"delivered {self._delivered})")
                self._cv.wait(timeout=min(left, 0.1))
            if self._delivered < n:
                raise EOFError(f"stream ended: need {n} samples, "
                               f"delivered {self._delivered}")

    def _note_lag(self):
        lag = (self._delivered - self._pos) / self.fs
        self.lag_last_s = lag
        if lag > self.lag_max_s:
            self.lag_max_s = lag
        if lag > self.miss_budget_s:
            self.lag_misses += 1

    def phase_mark(self, name: str) -> dict:
        """Close a phase: snapshot lag stats under `name` and reset the
        counters. Per-phase accounting matters because state transitions
        (LNAV decode, handoff) legitimately pause consumption — the
        real-time claims are per streaming phase: tracking holds lag ~0;
        DPE starts behind by the decode pause and must not fall further
        (lag_end <= lag_start: catching up, not losing ground)."""
        snap = {"lag_max_s": round(self.lag_max_s, 4),
                "lag_last_s": round(self.lag_last_s, 4),
                "lag_misses": self.lag_misses}
        self.phases[name] = snap
        self.lag_max_s = 0.0
        self.lag_misses = 0
        return snap

    def read_block(self):
        self._wait_for(self._pos + self.S)
        out = super().read_block()
        self._note_lag()
        return out

    def read_block_raw(self):
        self._wait_for(self._pos + self.S)
        out = super().read_block_raw()
        self._note_lag()
        return out

    def read_chunk_raw(self, k: int):
        self._wait_for(self._pos + k * self.S)
        out = super().read_chunk_raw(k)
        self._note_lag()
        return out

    def close(self):
        self._src.close()
