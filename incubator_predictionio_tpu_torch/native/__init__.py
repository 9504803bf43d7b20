"""The port's native (C++) host library and its build: the event log, the
CSR builder and the batch-body parser of
incubator_predictionio_tpu/native/__init__.py.

``src/eventlog.cc`` is the append-only event-store engine behind the
``cpplog`` backend (``data/storage/cpplog.py``): framed records with
header-level predicate pushdown, tombstones, the columnar interaction scan
and import, and frame-level replication reads and appends.
``src/csr_builder.cc`` turns COO triples into the degree-bucketed padded
rows ALS trains on (``ops/sparse.py``; wrapper in ``native/csr.py``).
``src/jsonparse.cc`` parses a uniform ``POST /batch/events.json`` body
straight into columnar arrays (``data/storage/base.
uniform_interactions_from_body``, the event server's batch route). All
three are compiled at first use with the host C++ compiler (``$CXX``, else
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
SOURCES = ("eventlog.cc", "csr_builder.cc", "jsonparse.cc")
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
    u64p = c.POINTER(c.c_uint64)
    i64p = c.POINTER(c.c_int64)
    # the event log (data/storage/cpplog.py)
    lib.pio_evlog_open.restype = c.c_void_p
    lib.pio_evlog_open.argtypes = [c.c_char_p]
    lib.pio_evlog_close.restype = None
    lib.pio_evlog_close.argtypes = [c.c_void_p]
    lib.pio_evlog_append.restype = c.c_int64
    lib.pio_evlog_append.argtypes = [
        c.c_void_p, c.c_int64, c.c_uint64, c.c_uint64, c.c_uint64,
        c.c_uint64, c.c_char_p, c.c_uint32,
    ]
    lib.pio_evlog_tombstone.restype = c.c_int64
    lib.pio_evlog_tombstone.argtypes = [c.c_void_p, c.c_int64]
    lib.pio_evlog_count.restype = c.c_int64
    lib.pio_evlog_count.argtypes = [c.c_void_p]
    lib.pio_evlog_compact_copy.restype = c.c_int64
    lib.pio_evlog_compact_copy.argtypes = [c.c_void_p, c.c_char_p]
    lib.pio_evlog_query.restype = c.c_int64
    lib.pio_evlog_query.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_uint64, c.c_uint64,
        u64p, c.c_int32, c.c_int32, c.c_int64, i64p, c.c_int64,
    ]
    lib.pio_evlog_find_id.restype = c.c_int64
    lib.pio_evlog_find_id.argtypes = [c.c_void_p, c.c_uint64, i64p, c.c_int64]
    lib.pio_evlog_read.restype = c.c_int32
    lib.pio_evlog_read.argtypes = [
        c.c_void_p, c.c_int64, c.c_char_p, c.c_int32,
    ]
    lib.pio_evlog_sync.restype = c.c_int64
    lib.pio_evlog_sync.argtypes = [c.c_void_p]
    lib.pio_evlog_entry_count.restype = c.c_int64
    lib.pio_evlog_entry_count.argtypes = [c.c_void_p]
    lib.pio_evlog_dead_count.restype = c.c_int64
    lib.pio_evlog_dead_count.argtypes = [c.c_void_p]
    lib.pio_evlog_file_size.restype = c.c_int64
    lib.pio_evlog_file_size.argtypes = [c.c_void_p]
    lib.pio_evlog_read_frames.restype = c.c_int64
    lib.pio_evlog_read_frames.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_char_p, i64p]
    lib.pio_evlog_append_frames.restype = c.c_int64
    lib.pio_evlog_append_frames.argtypes = [c.c_void_p, c.c_char_p,
                                            c.c_int64]
    lib.pio_evlog_hash_ids.restype = c.c_int64
    lib.pio_evlog_hash_ids.argtypes = [c.c_char_p, i64p, c.c_int64, u64p]
    # the columnar interaction scan ([min, max) entry range and a thread
    # count; the log mutex is held only for the header snapshot)
    lib.pio_evlog_scan_interactions.restype = c.c_void_p
    lib.pio_evlog_scan_interactions.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_char_p,
        c.c_char_p, c.POINTER(c.c_char_p), c.POINTER(c.c_double), c.c_int32,
        c.c_char_p, c.c_double, c.c_int32,
    ]
    lib.pio_scan_nnz.restype = c.c_int64
    lib.pio_scan_nnz.argtypes = [c.c_void_p]
    lib.pio_scan_lock_held_ns.restype = c.c_int64
    lib.pio_scan_lock_held_ns.argtypes = [c.c_void_p]
    lib.pio_scan_n_ids.restype = c.c_int64
    lib.pio_scan_n_ids.argtypes = [c.c_void_p, c.c_int32]
    lib.pio_scan_ids_bytes.restype = c.c_int64
    lib.pio_scan_ids_bytes.argtypes = [c.c_void_p, c.c_int32]
    lib.pio_scan_fill.restype = None
    lib.pio_scan_fill.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_float),
    ]
    lib.pio_scan_fill_times.restype = None
    lib.pio_scan_fill_times.argtypes = [c.c_void_p, i64p]
    lib.pio_scan_copy_ids.restype = None
    lib.pio_scan_copy_ids.argtypes = [
        c.c_void_p, c.c_int32, c.c_char_p, i64p,
    ]
    lib.pio_scan_free.restype = None
    lib.pio_scan_free.argtypes = [c.c_void_p]
    lib.pio_evlog_append_bulk.restype = c.c_int64
    lib.pio_evlog_append_bulk.argtypes = [
        c.c_void_p, c.c_int64, i64p, c.c_char_p, i64p, c.c_char_p,
    ]
    lib.pio_evlog_append_interactions.restype = c.c_int64
    lib.pio_evlog_append_interactions.argtypes = [
        c.c_void_p, c.c_int64, i64p,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_float),
        c.c_char_p, i64p, c.c_int64,
        c.c_char_p, i64p, c.c_int64,
        c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p, c.c_uint64,
    ]
    # the CSR builder
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


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit: the hash the event log's headers carry for predicate
    pushdown. 0 is reserved as the "no filter" sentinel, so a real hash of
    0 maps to 1 (a one-in-2⁶⁴ bias, invisible next to the exact-match
    recheck in the DAO)."""
    h = 0xCBF29CE484222325
    for byte in data:
        h ^= byte
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h or 1


def fnv1a64_table(blob: bytes, offsets):
    """FNV-1a of every entry of an interned id table (blob + int64
    offsets, the IdTable layout) in ONE native call: the writer-shard
    spray hashes whole tables per batch. Returns a uint64 array of
    ``len(offsets) - 1``. Raises where the library cannot be built and
    on a malformed table (an offset running backwards); the JAX package's
    counterpart hashes in Python then."""
    import numpy as np

    n = max(len(offsets) - 1, 0)
    offs = np.ascontiguousarray(offsets, np.int64)
    out = np.empty(n, np.uint64)
    rc = load().pio_evlog_hash_ids(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if rc != n:
        raise ValueError(f"malformed id table ({n} ids, native rc {rc})")
    return out
