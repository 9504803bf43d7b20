"""The port's native (C++) host library and its build: the CSR builder and
the batch-body parser of incubator_predictionio_tpu/native/__init__.py.

``src/csr_builder.cc`` turns COO triples into the degree-bucketed padded
rows ALS trains on (``ops/sparse.py``; wrapper in ``native/csr.py``).
``src/jsonparse.cc`` parses a uniform ``POST /batch/events.json`` body
straight into columnar arrays (``data/storage/base.
uniform_interactions_from_body``, the event server's batch route). Both
are compiled at first use with the host C++ compiler (``$CXX``, else
``g++``) into one shared library under the package's ``_build/``, cached
by a hash of the sources and the flags, and loaded with ctypes.

Unlike the JAX package, which logs a failed build and falls back to its
Python paths, :func:`load` raises: a caller that asked for the native route
gets it or an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

SRC_DIR = pathlib.Path(__file__).resolve().parent / "src"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("csr_builder.cc", "jsonparse.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> pathlib.Path:
    """The library for the current sources and flags."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((SRC_DIR / name).read_bytes())
    digest.update(" ".join((_compiler(),) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libpio_native_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless this hash is built; raise on failure."""
    so = lib_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a process-unique name, then an atomic rename: two processes building
    # at once never load a half-written library
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = [_compiler(), *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES),
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    except FileNotFoundError as exc:
        raise RuntimeError(f"native build failed: no compiler ({exc})"
                           ) from exc
    finally:
        tmp.unlink(missing_ok=True)
    return so


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64p = c.POINTER(c.c_int64)
    pp_i32 = c.POINTER(c.POINTER(c.c_int32))
    pp_f32 = c.POINTER(c.POINTER(c.c_float))
    lib.pio_csr_plan.restype = c.c_int64
    lib.pio_csr_plan.argtypes = [
        c.POINTER(c.c_int32), c.c_int64, c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, i64p,
    ]
    lib.pio_csr_fill.restype = c.c_int64
    lib.pio_csr_fill.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_float),
        c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_int32, i64p,
        pp_i32, pp_i32, pp_f32, pp_f32,
    ]
    # the uniform-batch body parser (the event server's batch route)
    lib.pio_parse_uniform_batch.restype = c.c_int64
    lib.pio_parse_uniform_batch.argtypes = [
        c.c_char_p, c.c_int64, c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_float),
        c.c_char_p, c.c_int64, i64p, i64p,
        c.c_char_p, c.c_int64, i64p, i64p,
        c.c_char_p, c.c_int64, i64p,
    ]


def load() -> ctypes.CDLL:
    """The native library, built on first use. Raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib
