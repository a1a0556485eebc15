"""Build and load the port's hand-written CUDA kernels.

Each source under fabind_tpu_torch/csrc/ is compiled by nvcc for sm_90a into
its own shared library with a plain C interface, loaded with ctypes. The
build happens at first use (or through `build_all`, which starts one nvcc per
source, all at once) into build/kernels/ at the root of the checkout. The
library's file name carries a hash of the source and the flags, so an edited
source rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


class CudaKernel:
    """One kernel source: its library, built on demand, and the count of
    launches its wrapper made (the wrapper calls `count_launch` once per
    launch; callers read and reset `launches`, and `variants`, the launches
    of a source's other kernels by name)."""

    def __init__(self, source: str,
                 symbols: Dict[str, Tuple[Sequence, object]]):
        self.source = CSRC_DIR / source
        self.symbols = symbols          # C function -> (argtypes, restype)
        self.launches = 0
        self.variants: Dict[str, int] = {}
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _start(self):
        """Start nvcc unless the library is already built; returns the
        process (or None) and the temporary output path."""
        if self.lib_path.exists():
            return None, None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.lib_path.with_name(
            f"{self.lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def _finish(self, proc, tmp) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                               f"{self.build_log}")
        os.replace(tmp, self.lib_path)

    def count_launch(self, variant: Optional[str] = None) -> None:
        """Add one launch (and one of `variant`, when named). Under the
        lock: `+=` is a read-modify-write, and the serving daemon and the
        data-parallel replicas launch from several threads."""
        with self._lock:
            self.launches += 1
            if variant is not None:
                self.variants[variant] = self.variants.get(variant, 0) + 1

    @property
    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._finish(*self._start())
                lib = ctypes.CDLL(str(self.lib_path))
                for name, (argtypes, restype) in self.symbols.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                self._lib = lib
            return self._lib


def build_all(kernels: List[CudaKernel]) -> None:
    """Compile every kernel not yet built, one nvcc per source, all started
    together; then load each library."""
    started = [(k, *k._start()) for k in kernels]
    for k, proc, tmp in started:
        k._finish(proc, tmp)
    for k in kernels:
        k.lib
