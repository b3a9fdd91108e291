"""ctypes bindings for the native CSV reader ``native/fastio.cpp`` (port of
``ransac_tpu.io.native``).

The source is compiled at first use with ``$CXX`` (default ``g++``) into
``build/native/libfastio_<hash>.so``, the name keyed by a hash of the
source and the flags as ``ops/_build.py`` keys the kernels, so an edited
source is rebuilt and an unchanged one reused.  Nothing is written into
``native/``, and no library found there is loaded.  ``available()`` says
whether the library could be built and loaded; callers choose the Python
CSV path when it cannot (``io.tables``, ``use_native``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_error: str | None = None


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the library of the current source, compiler and flags lives."""
    digest = hashlib.sha256(" ".join([compiler(), *FLAGS]).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastio_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/fastio.cpp`` into ``build/native/`` unless a library
    of the same source and flags is there; return its path.  Raises
    ``RuntimeError`` (with the compiler's stderr) when it cannot."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(compiler())
    if cxx is None:
        raise RuntimeError(f"fastio: no C++ compiler {compiler()!r} on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        obj = Path(tmp) / out.name
        proc = subprocess.run([cxx, *FLAGS, "-o", str(obj), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0 or not obj.exists():
            raise RuntimeError(f"fastio: {compiler()} failed (exit code {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(obj, out)
    return out


def load():
    """The library, built and loaded once; None if it cannot be (the
    reason is kept in ``error()``)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    lib.fastio_count_rows.argtypes = [ctypes.c_char_p]
    lib.fastio_count_rows.restype = ctypes.c_long
    lib.fastio_read_numeric.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_double]
    lib.fastio_read_numeric.restype = ctypes.c_long
    lib.fastio_read_strings.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_long, ctypes.c_int32]
    lib.fastio_read_strings.restype = ctypes.c_long
    _lib = lib
    _error = None
    return _lib


def error() -> str | None:
    """Why the last ``load()`` found no library (None if it did)."""
    return _error


def available() -> bool:
    return load() is not None


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError(f"fastio is not available: {_error}")
    return lib


def count_rows(path: str) -> int:
    """Data rows of a headered CSV (the header excluded)."""
    n = _require().fastio_count_rows(path.encode())
    if n < 0:
        raise IOError(f"fastio: cannot read {path}")
    return int(n)


def read_numeric(path: str, columns: list[int], fill_value: float = 0.0) -> np.ndarray:
    """The given numeric columns -> [rows, len(columns)] float64; empty or
    non-numeric cells become ``fill_value`` (the Python ingest's empty ->
    0.0)."""
    lib = _require()
    max_rows = count_rows(path) + 1
    cols = np.asarray(columns, np.int32)
    out = np.empty((max_rows, len(columns)), np.float64)
    n = lib.fastio_read_numeric(
        path.encode(), cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(columns),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows, fill_value)
    if n < 0:
        raise IOError(f"fastio: cannot read {path}")
    return out[:n]


def read_strings(path: str, column: int, width: int = 64) -> list[str]:
    """One string column (cells cut at ``width`` - 1 bytes)."""
    lib = _require()
    max_rows = count_rows(path) + 1
    buf = ctypes.create_string_buffer(max_rows * width)
    n = lib.fastio_read_strings(path.encode(), column, buf, max_rows, width)
    if n < 0:
        raise IOError(f"fastio: cannot read {path}")
    raw = buf.raw
    return [raw[i * width:(i + 1) * width].split(b"\0", 1)[0].decode("utf-8", "replace")
            for i in range(n)]
