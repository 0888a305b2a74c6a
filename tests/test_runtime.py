"""Native runtime (sample streamer, async logger) + flow runner tests."""

import os
import pathlib
import time

import numpy as np
import pytest

REPO = str(pathlib.Path(__file__).resolve().parent.parent)

from navlab_dpe_sdr_tpu.runtime.flow import FlowRunner, FlowStats, WatchdogError

try:
    from navlab_dpe_sdr_tpu.runtime.nativelib import (AsyncLogger,
                                                      SampleStream, load)
    load()
    HAVE_NATIVE = True
except Exception:
    HAVE_NATIVE = False

needs_native = pytest.mark.skipif(not HAVE_NATIVE,
                                  reason="native runtime unavailable")


@needs_native
def test_sample_stream_reads_blocks(tmp_path):
    s = 5000
    n_blocks = 17
    data = np.arange(n_blocks * s * 2, dtype=np.int16)
    path = tmp_path / "cap.dat"
    data.tofile(path)

    with SampleStream(str(path), block_samples=s, n_buffers=4) as st:
        for b in range(n_blocks):
            blk = st.next_block()
            assert blk is not None and blk.shape == (s, 2)
            expect = data[b * s * 2:(b + 1) * s * 2].reshape(s, 2)
            np.testing.assert_array_equal(blk, expect)
        assert st.next_block() is None  # clean EOF


@needs_native
def test_sample_stream_start_byte(tmp_path):
    s = 1000
    data = np.arange(10 * s * 2, dtype=np.int16)
    path = tmp_path / "cap.dat"
    data.tofile(path)
    with SampleStream(str(path), block_samples=s, n_buffers=2,
                      start_byte=3 * s * 4) as st:
        blk = st.next_block()
        np.testing.assert_array_equal(
            blk, data[3 * s * 2:4 * s * 2].reshape(s, 2))


@needs_native
def test_async_logger_roundtrip(tmp_path):
    path = tmp_path / "log.csv"
    rows = np.random.default_rng(0).standard_normal((50, 6))
    with AsyncLogger(str(path), n_cols=6, depth=8) as lg:
        for r in rows:
            lg.write(r)
    back = np.loadtxt(path, delimiter=",")
    np.testing.assert_allclose(back, rows, rtol=1e-10)


def test_flow_runner_stats_and_cap():
    calls = []

    def step():
        calls.append(1)
        time.sleep(0.001)
        return len(calls)

    runner = FlowRunner(step, watchdog_s=1.0, max_iterations=5)
    stats = runner.run(100)
    assert stats.n == 5
    assert stats.min_s > 0
    assert "iterations" in stats.summary()


def test_flow_runner_watchdog():
    def slow():
        time.sleep(0.05)

    runner = FlowRunner(slow, watchdog_s=0.01)
    with pytest.raises(WatchdogError):
        runner.run(3)


def test_flow_runner_eof_stops():
    n = [0]

    def step():
        n[0] += 1
        if n[0] > 3:
            raise EOFError
        return n[0]

    runner = FlowRunner(step, watchdog_s=None)
    stats = runner.run()
    assert stats.n == 3


def test_async_logger_binary_mode(tmp_path):
    """Binary format: raw little-endian f64 rows (datalogger.cu:45-50)."""
    from navlab_dpe_sdr_tpu.runtime.nativelib import AsyncLogger

    path = tmp_path / "rows.bin"
    rows = np.arange(12, dtype=np.float64).reshape(4, 3)
    with AsyncLogger(str(path), n_cols=3, binary=True) as lg:
        for r in rows:
            lg.write(r)
    got = np.fromfile(path, dtype=np.float64).reshape(4, 3)
    np.testing.assert_array_equal(got, rows)


def test_port_logger_complex_and_any_port(tmp_path):
    """PortLogger: any-port attachment, complex interleave re,im
    (datalogger.cu:34, 241-243)."""
    from navlab_dpe_sdr_tpu.runtime.nativelib import PortLogger

    state = {"v": np.array([1 + 2j, 3 - 4j])}
    path = tmp_path / "port.csv"
    with PortLogger(str(path), lambda: state["v"]) as pl:
        pl.step()
        state["v"] = np.array([5 + 6j, 7 + 8j])
        pl.step()
    rows = np.loadtxt(path, delimiter=",")
    np.testing.assert_array_equal(rows, [[1, 2, 3, -4], [5, 6, 7, 8]])

    bpath = tmp_path / "port.bin"
    with PortLogger(str(bpath), lambda: np.arange(5), binary=True) as pl:
        pl.step()
    np.testing.assert_array_equal(np.fromfile(bpath, np.float64),
                                  np.arange(5.0))


def test_raw_prefetcher_lifecycle():
    """_RawPrefetcher: stages batches in order, surfaces reader errors on
    get(), and close() unblocks/joins the reader thread even when the
    consumer abandons the queue mid-run (the exception path of
    run_batched/run_integrated)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from navlab_dpe_sdr_tpu.models.dpe import _RawPrefetcher

    class FakeRaw:
        def __init__(self, n_blocks, fail_at=None):
            self.i = 0
            self.n = n_blocks
            self.fail_at = fail_at

        def read_block_raw(self):
            if self.fail_at is not None and self.i == self.fail_at:
                raise IOError("disk gone")
            if self.i >= self.n:
                raise EOFError("past end")
            b = np.full((10, 2), self.i, np.int16)
            self.i += 1
            return b

    # in-order staging
    pf = _RawPrefetcher(FakeRaw(6), [2, 2, 2])
    firsts = [int(np.asarray(pf.get())[0, 0, 0]) for _ in range(3)]
    assert firsts == [0, 2, 4]
    pf.close()
    assert not pf._thread.is_alive()

    # reader error surfaces on the consumer side
    pf = _RawPrefetcher(FakeRaw(6, fail_at=3), [2, 2, 2])
    assert int(np.asarray(pf.get())[0, 0, 0]) == 0
    import pytest as _pytest
    with _pytest.raises(IOError):
        pf.get()
    pf.close()

    # consumer abandons after one batch: close() must not deadlock on the
    # reader's bounded put and must join the thread
    pf = _RawPrefetcher(FakeRaw(20), [2] * 10)
    pf.get()
    pf.close()
    assert not pf._thread.is_alive()


@needs_native
def test_sample_stream_tcp(tmp_path):
    """Native TCP sample source: fixed-size blocks over a live socket with
    a start-byte skip and clean EOF on peer close (the reference's broken
    socket mode, sampleblock.cu:134-156, working)."""
    import socket
    import threading

    from navlab_dpe_sdr_tpu.runtime.nativelib import SampleStream

    n_blocks, s = 4, 250
    data = (np.arange(n_blocks * s * 2, dtype=np.int16)
            .reshape(n_blocks, s, 2))
    skip = 24  # bytes of stream preamble to discard

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"\x55" * skip + data.tobytes())
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with SampleStream(f"tcp://127.0.0.1:{port}", block_samples=s,
                      start_byte=skip, timeout_s=5.0) as st:
        for k in range(n_blocks):
            blk = st.next_block()
            np.testing.assert_array_equal(blk, data[k])
        assert st.next_block() is None        # peer closed -> clean EOF
    t.join(timeout=2.0)
    srv.close()


def test_paced_replay_server_rate(tmp_path):
    """PacedReplayServer delivers at the configured wall-clock sample rate
    (RunLive delivery model, sampleblock.cu:421-426)."""
    import socket
    import time

    from navlab_dpe_sdr_tpu.io.netsource import PacedReplayServer

    fs = 500_000.0                      # 2 MB/s — cheap to pace in a test
    path = tmp_path / "cap.bin"
    path.write_bytes(b"\x11" * int(fs * 4 * 2))      # 2 s of samples
    srv = PacedReplayServer(str(path), fs=fs)
    got = 0
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", srv.port)) as c:
        c.settimeout(2.0)
        while time.perf_counter() - t0 < 0.6:
            got += len(c.recv(65536))
    elapsed = time.perf_counter() - t0
    rate = got / elapsed
    assert 0.75 * fs * 4 < rate < 1.25 * fs * 4, rate


def test_flowrunner_source_split():
    """Iteration timing starts after the source returns (flow.cu:132-135):
    a slow source must NOT count against the real-time budget."""
    import time

    from navlab_dpe_sdr_tpu.runtime.flow import FlowRunner

    n = {"i": 0}

    def source():
        if n["i"] >= 5:
            return None
        n["i"] += 1
        time.sleep(0.05)                # sample delivery: 50 ms
        return n["i"]

    def step(blk):
        time.sleep(0.002)               # compute: 2 ms
        return blk

    r = FlowRunner(step, watchdog_s=1.5, realtime_budget_s=0.02,
                   source_fn=source)
    stats = r.run()
    assert stats.n == 5
    assert r.realtime_misses == 0       # 50 ms waits never counted
    assert stats.avg_s < 0.02


def test_cli_live_paced(tmp_path):
    """End-to-end live mode through the CLI: paced TCP delivery, batched
    processing, drop accounting, JSON record."""
    import json
    import subprocess
    import sys

    cap, hand = tmp_path / "cap.dat", tmp_path / "hand.csv"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "navlab_dpe_sdr_tpu.cli", "--device", "cpu",
         "synth", "--out", str(cap), "--handoff", str(hand),
         "--seconds", "1.0", "--cn0", "50"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-800:]
    out = tmp_path / "live.json"
    r = subprocess.run(
        [sys.executable, "-m", "navlab_dpe_sdr_tpu.cli", "--device", "cpu",
         "live", str(cap), "--handoff", str(hand), "--lookahead", "10",
         "--seconds", "0.8", "--grid", "uniform", "--grid-n", "7",
         "--watchdog", "60", "--json", str(out)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-1500:]
    rec = json.loads(out.read_text())
    assert rec["blocks"] == 40
    assert rec["iterations"] == 4
    assert rec["server_behind_max_ms"] < 500.0
    assert "rt_misses" in rec and "margin_x" in rec


def test_native_load_always_runs_make(monkeypatch):
    """load() goes through make even when a library is already there, so
    the library always matches the committed sources."""
    import subprocess as sp

    from navlab_dpe_sdr_tpu.runtime import nativelib
    real_run = sp.run
    calls = []

    def spy(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(nativelib, "_lib", None)
    monkeypatch.setattr(nativelib.subprocess, "run", spy)
    assert nativelib.load() is not None
    assert nativelib._LIB.exists()
    monkeypatch.setattr(nativelib, "_lib", None)
    nativelib.load()
    assert [c[:2] for c in calls] == [["make", "-C"], ["make", "-C"]]

