"""Builds the port's CUDA C++ kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled on first use, on the machine with the card, into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout
(``.gitignore`` lists ``build/``). The digest covers the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import: this module is imported on machines with
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was reused
    log: str  # nvcc's output, ptxas' registers and spills among it


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Built]:
    """Compile the named sources, one nvcc process each, all started
    together; a library already built from the same source is reused."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    done: Dict[str, Built] = {}
    for name in names:
        so = _target(name)
        if so.exists():
            done[name] = Built(so, 0.0, "reused")
            continue
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, so, tmp, time.perf_counter())
    failed = []
    for name, (proc, so, tmp, t0) in started.items():
        log, _ = proc.communicate()  # wait for every nvcc before raising
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, so)  # atomic: concurrent builders never see half
        done[name] = Built(so, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name].path))
        _LIBS[name] = lib
    return lib
