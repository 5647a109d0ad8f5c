"""Build ``csrc/*.cu`` with nvcc and load the libraries with ctypes.

Each source compiles to a shared library with a plain C interface: no
PyTorch headers, so a build takes seconds.  Every pointer and the stream
cross the boundary as ``ctypes.c_void_p`` (a plain ``int`` argument would be
cut to 32 bits), and every entry point returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

A library is built once per process, on first use, into ``build/repro_torch/``
at the root of the checkout (``.gitignore`` lists ``build/``), under a name
that hashes its source, every shared header ``csrc/*.cuh`` and the flags, so
an edit to any of them builds anew.  A missing
``nvcc`` or a failed build raises: there is no fallback to the plain
PyTorch version for a tensor that lives on the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    if TOOLKIT_NVCC.exists():
        return str(TOOLKIT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built on first use and need the CUDA toolkit")


def _output(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _output(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: concurrent processes may build too
    _libs[name] = ctypes.CDLL(str(out))


def build(*names: str) -> dict[str, ctypes.CDLL]:
    """Build and load the named sources not yet loaded in this process.

    One ``nvcc`` per source, all started together, then waited for.
    Returns the loaded libraries by name.
    """
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        errors = []
        for name, proc, tmp, out in started:
            try:
                _finish(name, proc, tmp, out)
            except RuntimeError as err:
                errors.append(str(err))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: _libs[n] for n in names}


def library(name: str, signatures: dict[str, tuple[int, ...]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (or
    loaded, where a build of the same sources is already on disk).

    ``signatures`` maps each C entry point to its count of pointer, int and
    (optionally) float arguments (the stream comes last); see
    :func:`declare`.
    """
    lib = _libs.get(name)
    if lib is None:
        built = _output(name)      # named by the digest of these sources
        with _lock:
            if name not in _libs and built.exists():
                # built by another process of this checkout (the ranks of a
                # mesh load what their parent built): load it, do not rebuild
                _libs[name] = ctypes.CDLL(str(built))
        lib = _libs.get(name) or build(name)[name]
    for fn, counts in signatures.items():
        declare(getattr(lib, fn), *counts)
    return lib


def build_log(name: str) -> str:
    """nvcc's output for the last build of ``name`` (ptxas usage lines)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of SMs of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def int_outputs(lib: ctypes.CDLL, name: str, n: int, device) -> tuple:
    """Call the C entry point ``name(int*, ..., int*)`` of ``n`` outputs on
    ``device`` and return them (an occupancy query, say)."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * n
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(n)]
    with torch.cuda.device(device):
        check(fn(*(ctypes.byref(v) for v in out)), name)
    return tuple(v.value for v in out)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def expect(t, name: str, shape: tuple, dtypes: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and one of
    ``dtypes`` on ``device`` — what a kernel takes through a raw pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether a contiguous tensor can be a TMA source: its base on a
    16-byte boundary and every stride a multiple of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        (st * t.element_size()) % 16 == 0 for st in t.stride()[:-1])


def rows_aligned(K: int, tensors) -> bool:
    """Whether a kernel may move 4 lanes at a time (16 bytes of float32 or
    int32, 8 of bf16, 4 of int8) along every row of length K of
    ``tensors``: K a multiple of 4 and each tensor's first element on a
    boundary of 4 of its elements.  Each row of a contiguous (n, K) tensor
    then starts on one as well."""
    return K % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def forbid_autograd(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad is enabled and one of
    ``tensors`` requires grad: the kernels have no backward (neither do the
    reference's Pallas calls), and an output computed through a raw pointer
    carries no autograd history, so a gradient would be dropped silently."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward: its output would carry no gradient; "
            "train with use_pallas=False")


def route(backend: str | None, device) -> str:
    """Which version a call takes: ``"cuda"`` (the kernel) or ``"torch"``.

    ``backend="torch"`` forces the plain PyTorch version.  Otherwise CPU
    tensors take the plain version and CUDA tensors the kernel; nothing
    else is accepted, and nothing falls back.
    """
    if backend == "torch":
        return "torch"
    if backend is not None:
        raise ValueError(f"backend must be None or 'torch', got {backend!r}")
    if device.type in ("cuda", "cpu"):
        return "cuda" if device.type == "cuda" else "torch"
    raise ValueError(f"no kernel or plain version for device {device}")


def declare(fn, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """Set a C entry point's signature: pointers, then ints, then floats
    (``float`` by value: a Python float is rounded to float32 once, as
    ``np.float32`` rounds it), then the stream."""
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
