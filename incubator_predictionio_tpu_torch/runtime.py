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
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Union

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: the H100 SXM's peak rates at 700 W (NVIDIA data sheet), the yardstick of
#: every kernel bound: HBM3 bytes/s, f32 FMA-unit FLOP/s (no tensor cores),
#: dense TF32 and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
#: the fastest f32-accurate products: 3xTF32 on the tensor cores, three TF32
#: products each (the bound of every f32 product; ``F32_FLOPS`` is kept
#: beside it as the FMA units' rate)
F32_3XTF32_FLOPS = TF32_FLOPS / 3


_CONSTEXPR = re.compile(r"^constexpr\s+int\s+(\w+)\s*=\s*([^;]+);",
                        re.MULTILINE)


@functools.lru_cache(maxsize=None)
def csrc_constants(source: str) -> Dict[str, int]:
    """The namespace-scope integer constants (``constexpr int NAME =
    EXPR;`` at the start of a line) of ``csrc/<source>`` whose expression
    reduces to integer literals and earlier such constants, by name. The
    launch plans read their tile sizes here, so that the kernel source is
    their only owner. Read only, never changed."""
    found: Dict[str, int] = {}
    for name, expr in _CONSTEXPR.findall((CSRC_DIR / source).read_text()):
        expr = re.sub(r"\b[A-Za-z_]\w*\b",
                      lambda m: str(found.get(m.group(0), m.group(0))), expr)
        if re.fullmatch(r"[\d\s+\-*/()]+", expr):  # literals only: safe
            found[name] = int(eval(expr.replace("/", "//")))
    return found


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


def requested_device() -> Optional[str]:
    """The device the CLI's ``train`` and ``deploy`` run on:
    ``PIO_DEVICE`` when set (``cpu`` is the one switch to the CPU, the
    counterpart of the JAX package's ``JAX_PLATFORMS=cpu``), else None,
    which :func:`default_device` takes for CUDA."""
    return os.environ.get("PIO_DEVICE") or None


_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached): the launch
    plans size their grids from it."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


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
_tag: Optional[str] = None
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


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(map(str, cmd))}):\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    sz = ctypes.c_size_t
    lib.pio_score_topk.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, sz, p]
    lib.pio_score_topk.restype = ctypes.c_int
    lib.pio_score_topk_workspace_bytes.argtypes = [i, i, i]
    lib.pio_score_topk_workspace_bytes.restype = sz
    lib.pio_als_solve_cg.argtypes = [p, i, p, p, p, p, i, i, i, i, i,
                                     i, i, p, sz, p]
    lib.pio_als_solve_cg.restype = ctypes.c_int
    lib.pio_als_gather_rows.argtypes = [p, i, i, p, p, ctypes.c_longlong, i,
                                        p, p]
    lib.pio_als_gather_rows.restype = ctypes.c_int
    lib.pio_als_workspace_bytes.argtypes = [i, i, i]
    lib.pio_als_workspace_bytes.restype = sz
    lib.pio_als_group_rows.argtypes = [i, i, i]
    lib.pio_als_group_rows.restype = ctypes.c_int
    lib.pio_als_fused_solve_cg.argtypes = [p, i, i, p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, p, sz, p]
    lib.pio_als_fused_solve_cg.restype = ctypes.c_int
    ll = ctypes.c_longlong
    lib.pio_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                        ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                        i, ctypes.c_float, i, p, p]
    lib.pio_flash_attention.restype = ctypes.c_int
    lib.pio_flash_workspace_bytes.argtypes = [i, i, i, i, i]
    lib.pio_flash_workspace_bytes.restype = ctypes.c_size_t
    lib.pio_flash_smem_bytes.argtypes = [i, i]
    lib.pio_flash_smem_bytes.restype = ctypes.c_size_t


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library. Each
    source compiles in its own ``nvcc``, all started together, then one
    link. Raises on any failure."""
    global _lib, _tag
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
        _tag = tag
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
                    for s, f in zip(sources, futs):
                        (BUILD_DIR / f"{s.stem}_{tag}.ptxas").write_text(
                            f.result())
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


def kernel_resources(stem: str) -> List[Dict[str, object]]:
    """What ``ptxas -v`` reported for each kernel of ``csrc/<stem>.cu`` in
    the loaded build: the mangled name, registers a thread, spill stores
    and loads (bytes) and static shared memory (bytes; the flash kernel's
    is dynamic). Empty when the build directory holds no report."""
    if _tag is None:
        raise RuntimeError("build_kernels() has not run")
    path = BUILD_DIR / f"{stem}_{_tag}.ptxas"
    if not path.exists():
        return []
    out: List[Dict[str, object]] = []
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append({"function": m.group(1)})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
