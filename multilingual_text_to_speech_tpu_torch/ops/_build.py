"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled on first use into ``build/kernels/lib<name>_<hash>.so`` at the
root of the checkout; the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds.  A build takes
seconds: the sources include no PyTorch header.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("fused_decoder", "fused_train_decoder")
# no --use_fast_math: the W8A8 row quantization must round exactly like the
# plain version (IEEE division, rintf)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    csrc = _PKG / "csrc"
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES, force: bool = False
          ) -> Dict[str, str]:
    """Compile the named sources, one nvcc process each, all started
    together.  Returns nvcc's output per source (``-Xptxas -v``: registers,
    shared memory, spills) for those built now.  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists() and not force:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(_PKG / "csrc" / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        os.replace(tmp, out)
        logs[name] = text
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if missing."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]
