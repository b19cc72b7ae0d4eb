"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled on its own, at first use, into a shared
library with a plain C interface under ``build/kernels/`` at the root of the
checkout, for ``sm_90a`` (Hopper).  A library's name carries a digest of its
source, of every header in ``csrc/`` and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded.  Nothing is
compiled when a module is imported: the CPU tests import every module on
machines that have no ``nvcc``.

A :class:`CudaKernel` owns one library and one C entry point, and counts the
launches that entry point accepted (``launches``), so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["CudaKernel", "build_all", "nvcc_path", "stream_of", "BUILD_DIR",
           "DTYPE_CODES"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/kernels (this file is <checkout>/src/repro_torch/kernels/build.py)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: must match csrc/common.cuh:repro::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``.  Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the PATH); "
                       "the port's CUDA kernels are built from source at first use")


class CudaKernel:
    """One CUDA source built into its own shared library, and the C entry
    point in it that launches the kernel.

    ``launch(*args)`` calls the entry point, raises if it returned a CUDA
    error (a refused launch never runs, and a later synchronise would not
    report it), and only then adds one to ``launches``.
    """

    def __init__(self, source: str, entry: str, argtypes: Sequence):
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._error_string = None

    @property
    def library_path(self) -> Path:
        """The library's path, named by a digest of the source, every header
        under ``csrc/`` (a source may include any of them) and the flags."""
        h = hashlib.sha256()
        for f in [CSRC / self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[Tuple[subprocess.Popen, str]]:
        """Start ``nvcc`` on this source into a temporary file; None when
        the library is already built."""
        if self.library_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        return proc, tmp

    def _finish_build(self, started: Optional[Tuple[subprocess.Popen, str]]) -> None:
        if started is None:
            return
        proc, tmp = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, self.library_path)  # atomic: never a half-written .so

    def load(self) -> None:
        """Build (if needed) and load the library; idempotent."""
        if self._fn is not None:
            return
        self._finish_build(self._start_build())
        lib = ctypes.CDLL(str(self.library_path))
        fn = getattr(lib, self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.repro_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn, self._error_string = lib, fn, err

    def function(self, name: str, argtypes: Sequence, restype=ctypes.c_int):
        """Another C function of this kernel's library (built and loaded on
        first use), e.g. a query of which kernel a call would take."""
        self.load()
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn

    def launch(self, *args) -> None:
        self.load()
        code = self._fn(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.entry} launch failed: CUDA error {code} ({msg})")
        self.launches += 1


def build_all(kernels: List[CudaKernel]) -> None:
    """Build every kernel's library at once (one ``nvcc`` per source, all
    started together), then load them.  Each kernel's compiler output,
    with ``-Xptxas -v``'s register, shared-memory and spill lines, is left
    in its ``build_log`` (empty when the library was already built)."""
    started = [k._start_build() if k._fn is None else None for k in kernels]
    errors = []
    for k, st in zip(kernels, started):
        try:
            k._finish_build(st)
        except RuntimeError as e:  # keep waiting on the others, then report all
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.load()


def stream_of(t: torch.Tensor) -> int:
    """The handle (``cudaStream_t``) of PyTorch's current stream on ``t``'s
    device.  The raw getter is the one PyTorch's own generated kernels call;
    ``torch.cuda.current_stream(device).cuda_stream`` gives the same handle
    but builds a ``Stream`` object on every call, several microseconds of
    host time per launch (``scripts/torch_host_cost.py``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
