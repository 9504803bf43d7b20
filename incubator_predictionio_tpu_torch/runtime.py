"""Device choice, kernel build and launch counts.

Counterpart of the Mosaic probes in incubator_predictionio_tpu/ops/
pallas_kernels.py (:59-174). The TPU package probed whether a kernel
compiled and fell back to XLA when it did not; this package does not fall
back. :func:`default_device` is CUDA unless the caller asks for the CPU,
and raises when CUDA is absent. :func:`build_kernels` compiles every
``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into one shared library under
``_build/`` (cached by a hash of the sources) and loads it with ctypes; a
build failure raises, and so does a kernel whose launch fails.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional, Union

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def default_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, and raises when
    no CUDA device is present (pass ``"cpu"`` to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


class LaunchCounter:
    """Count of a kernel's launches, thread-safe. A wrapper calls
    :meth:`add` where it launches its kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0
        _COUNTERS[name] = self

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def reset(self) -> None:
        with self._lock:
            self._value = 0


_COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counts() -> Dict[str, int]:
    return {name: c.value for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(map(str, cmd))}):\n"
            f"{proc.stdout}{proc.stderr}")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pio_score_topk.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
    lib.pio_score_topk.restype = ctypes.c_int
    lib.pio_score_topk_workspace_bytes.argtypes = [i, i, i]
    lib.pio_score_topk_workspace_bytes.restype = ctypes.c_size_t


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library. Each
    source compiles in its own ``nvcc``, all started together, then one
    link. Raises on any failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC_DIR.glob("*.cu"))
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
        digest = hashlib.sha256()
        for src in sorted(CSRC_DIR.glob("*.cu*")):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        tag = digest.hexdigest()[:16]
        target = BUILD_DIR / f"libpio_kernels_{tag}.so"
        if not target.exists():
            nvcc = _nvcc()
            work = BUILD_DIR / f"tmp_{tag}_{os.getpid()}"
            work.mkdir(parents=True, exist_ok=True)
            try:
                objs = [work / (s.stem + ".o") for s in sources]
                with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
                    futs = [ex.submit(_run, [nvcc, *NVCC_FLAGS, "-c", str(s),
                                             "-o", str(o)])
                            for s, o in zip(sources, objs)]
                    for f in futs:
                        f.result()
                tmp = work / target.name
                _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", "-o", str(tmp), *map(str, objs)])
                os.replace(tmp, target)
            finally:
                shutil.rmtree(work, ignore_errors=True)
        lib = ctypes.CDLL(str(target))
        _declare(lib)
        _lib = lib
        return lib


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
