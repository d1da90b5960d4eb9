"""Build and bind the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exports plain C launchers
(``extern "C"``, pointers and the stream as ``void*``, returning
``cudaGetLastError()``).  At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``fgs_nerf_tpu_torch/_build/`` (git-ignored), named by
the hash of its source so a changed source is rebuilt, and loaded with
``ctypes``; the hash covers the shared headers ``csrc/*.cuh`` too.
``build_all`` starts one ``nvcc`` per source at once.

A build failure raises; a launcher returning a nonzero CUDA error code
raises.  Nothing here falls back to the plain PyTorch paths: the
wrappers choose those only for tensors that lie on the CPU.

Every C launcher has a launch count (``CudaKernel.launches[name]``),
raised by one where ``call`` has launched it and nowhere else, so a run
can show which kernels a path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class CudaKernel:
    """One ``.cu`` source, its C launchers and its launch count."""

    def __init__(self, name: str, source: str, replaces: str,
                 launchers: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC_DIR / source
        self.replaces = replaces
        self.launchers = dict(launchers)
        self.launches = {fn: 0 for fn in self.launchers}
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def source_rel(self) -> str:
        return str(self.source.relative_to(_PKG_DIR.parent))

    def _paths(self):
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared device code
            h.update(header.read_bytes())
        digest = h.hexdigest()[:12]
        stem = BUILD_DIR / f"lib{self.source.stem}_{digest}"
        return stem.with_suffix(".so"), stem.with_suffix(".log")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` unless the library for this source exists."""
        so, log = self._paths()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc._fgs_paths = (tmp, so, log)  # type: ignore[attr-defined]
        return proc

    @staticmethod
    def finish_build(proc: subprocess.Popen) -> None:
        tmp, so, log = proc._fgs_paths  # type: ignore[attr-defined]
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
        os.replace(tmp, so)

    def build_log(self) -> str:
        _, log = self._paths()
        return log.read_text() if log.exists() else ""

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            proc = self.start_build()
            if proc is not None:
                self.finish_build(proc)
            so, _ = self._paths()
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in self.launchers.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Run one C launcher; raise on a nonzero CUDA error code."""
        rc = getattr(self.lib(), fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")
        self.launches[fn] += 1


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Compile every missing library in parallel, then load them all."""
    kernels = list(kernels)
    procs: List[subprocess.Popen] = []
    for k in kernels:
        if k._lib is None:
            p = k.start_build()
            if p is not None:
                procs.append(p)
    errors = []
    for p in procs:
        try:
            CudaKernel.finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
