"""ctypes bindings for the native runtime (sample streamer + async logger).

The shared library is built by make from the sources in native/ on first
use in a process (make is a no-op when it is current); if no C++ toolchain
is available the callers fall back to the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent / "native"
_LIB = _DIR / "libnavruntime.so"
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def load():
    global _lib
    if _lib is not None:
        return _lib
    # always through make (a no-op when current): a library left behind by
    # other sources is rebuilt from the committed ones. The lock keeps
    # concurrent processes from writing the library at the same time.
    try:
        with open(_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", str(_DIR)], check=True,
                           capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeUnavailable(f"cannot build native runtime: {e}")
    lib = ctypes.CDLL(str(_LIB))
    lib.sr_open.restype = ctypes.c_void_p
    lib.sr_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                            ctypes.c_long, ctypes.c_double]
    lib.sr_open_tcp.restype = ctypes.c_void_p
    lib.sr_open_tcp.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_long, ctypes.c_int,
                                ctypes.c_long, ctypes.c_double]
    lib.sr_next.restype = ctypes.c_long
    lib.sr_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sr_depth.restype = ctypes.c_int
    lib.sr_depth.argtypes = [ctypes.c_void_p]
    lib.sr_close.argtypes = [ctypes.c_void_p]
    lib.lg_open.restype = ctypes.c_void_p
    lib.lg_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_double]
    lib.lg_open2.restype = ctypes.c_void_p
    lib.lg_open2.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_double, ctypes.c_int]
    lib.lg_write.restype = ctypes.c_int
    lib.lg_write.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_double)]
    lib.lg_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class SampleStream:
    """Threaded block reader over a capture file (native ring buffer).

    Equivalent of CUDARecv's SampleBlock producer thread + 32-deep ring
    (sampleblock.cu:307-515). Yields int16 I/Q blocks of block_samples.
    """

    def __init__(self, path: str, block_samples: int, n_buffers: int = 32,
                 start_byte: int = 0, bytes_per_sample: int = 4,
                 timeout_s: float = 1.5):
        """path: a capture file, or "tcp://host:port" for the live socket
        source (reference sampleblock.cu:134-156 — working here)."""
        lib = load()
        self._lib = lib
        self.block_samples = block_samples
        self.block_bytes = block_samples * bytes_per_sample
        if path.startswith("tcp://"):
            host, _, port = path[6:].rpartition(":")
            self._h = lib.sr_open_tcp(host.encode(), int(port),
                                      self.block_bytes, n_buffers,
                                      start_byte, timeout_s)
        else:
            self._h = lib.sr_open(path.encode(), self.block_bytes,
                                  n_buffers, start_byte, timeout_s)
        if not self._h:
            raise OSError(f"sr_open failed for {path}")
        self._buf = np.empty(self.block_bytes, dtype=np.uint8)

    def next_block(self) -> np.ndarray | None:
        """Next block as int16 [S, 2], or None at EOF. Raises TimeoutError
        on watchdog expiry (reference crash semantics)."""
        got = self._lib.sr_next(self._h, self._buf.ctypes.data_as(
            ctypes.c_void_p))
        if got < 0:
            raise TimeoutError("sample stream watchdog expired")
        if got < self.block_bytes:
            return None
        return self._buf.view(np.int16).reshape(self.block_samples, 2).copy()

    @property
    def depth(self) -> int:
        return self._lib.sr_depth(self._h)

    def close(self):
        if self._h:
            self._lib.sr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncLogger:
    """Non-blocking CSV row logger (native writer thread).

    Equivalent of CUDARecv's DataLogger/XECEFLogger (datalogger.cu:45-278).
    """

    def __init__(self, path: str, n_cols: int, depth: int = 64,
                 timeout_s: float = 1.5, binary: bool = False):
        lib = load()
        self._lib = lib
        self.n_cols = n_cols
        self.binary = binary
        self._h = lib.lg_open2(path.encode(), n_cols, depth, timeout_s,
                               1 if binary else 0)
        if not self._h:
            raise OSError(f"lg_open failed for {path}")

    def write(self, row) -> None:
        arr = np.ascontiguousarray(row, dtype=np.float64)
        assert arr.size == self.n_cols
        rc = self._lib.lg_write(self._h, arr.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise TimeoutError("logger ring full past watchdog")

    def close(self):
        if self._h:
            self._lib.lg_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PortLogger:
    """Attach an async logger to ANY receiver port (datalogger.cu:34:
    DATATYPE_ANY / VALUETYPE_ANY / VECTORLENGTH_ANY).

    `getter` produces the port value each step: any array-like of fixed
    size, real or complex (complex is interleaved re,im per element,
    datalogger.cu:241-243). Column count is latched from the first value;
    format is CSV or raw binary float64.
    """

    def __init__(self, path: str, getter, binary: bool = False,
                 depth: int = 64, timeout_s: float = 1.5):
        self.path = path
        self.getter = getter
        self.binary = binary
        self.depth = depth
        self.timeout_s = timeout_s
        self._logger: AsyncLogger | None = None
        self.rows = 0

    @staticmethod
    def _flatten(value) -> np.ndarray:
        arr = np.asarray(value)
        if np.iscomplexobj(arr):
            arr = np.stack([arr.real, arr.imag], axis=-1)
        return np.ravel(arr).astype(np.float64)

    def step(self):
        row = self._flatten(self.getter())
        if self._logger is None:
            self._logger = AsyncLogger(self.path, n_cols=row.size,
                                       depth=self.depth,
                                       timeout_s=self.timeout_s,
                                       binary=self.binary)
        self._logger.write(row)
        self.rows += 1

    def close(self):
        if self._logger is not None:
            self._logger.close()
            self._logger = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
