"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles each source in ``csrc/`` to an object file, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which ctypes loads. Every fresh checkout
builds from nothing, so the build takes about the time of the slowest
source, not of all of them in a row. The library's name
carries a hash of the sources and flags: an edit rebuilds, an unchanged
tree reuses the build. The build goes to ``build/fluidsimulation_tpu_torch/``
beside the package and uses only the CUDA toolkit's own headers.

The flags are fixed: sm_90a (Hopper), -O3, and -fmad=false. The level-set
kernels pick among near-ties with a strict `<`, and a contracted
multiply-add would move their distances by an ulp; the other kernels keep
the plain versions' rounding the same way. No --use_fast_math.

Nothing here runs at import: the library is built on the first launch (or
by ``build()``), so the package imports on a machine without a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fluidsimulation_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfst_kernels_{h.hexdigest()[:16]}.so"


def _run_all(commands: list[list[str]]) -> str:
    """Run the commands at once; return their joined output, or raise with
    it if any failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    outs = [proc.communicate()[0] for proc in procs]
    failed = [(cmd, proc.returncode) for cmd, proc in zip(commands, procs) if proc.returncode]
    if failed:
        raise RuntimeError(
            "nvcc failed: "
            + "; ".join(f"{Path(cmd[-1]).name} exit code {rc}" for cmd, rc in failed)
            + "\n" + "".join(outs)
        )
    return "".join(outs)


def build() -> Path:
    """Compile the kernels unless a build of these sources exists. Raises
    with the compiler's output if nvcc fails. The compiler's report
    (registers, spills) is kept beside the library as ``.log``."""
    lib = _library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{lib.stem}.{os.getpid()}"
    cu = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in cu]
    tmp = lib.with_name(f"{stem}.so.tmp")
    nvcc = _nvcc()
    try:
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            for src, obj in zip(cu, objs)
        ])
        log += _run_all([[nvcc, "-shared", *ARCH, "-o", str(tmp), *map(str, objs)]])
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fst_error_string.argtypes = [ctypes.c_int]
        lib.fst_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P = ctypes.c_void_p  # device pointer or stream
I = ctypes.c_int
INTS = ctypes.POINTER(ctypes.c_int)  # host array of ints
L = ctypes.c_longlong
F = ctypes.c_float


class Kernel:
    """One C entry point of the kernel library and its launch count.

    ``launches`` grows by one for each launch that the entry point accepted;
    nothing else touches it except a caller that resets it."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        # Every entry point takes the stream last. Without argtypes ctypes
        # would pass each pointer as a 32-bit int and cut it.
        self.argtypes = [*argtypes, P]
        self.launches = 0
        self._fn = None

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            text = load_library().fst_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {text}")
        self.launches += 1


def check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> int:
    """Validate a kernel argument and return its device pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def same_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    return dev
