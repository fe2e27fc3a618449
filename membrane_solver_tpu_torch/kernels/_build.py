"""Build the CUDA sources of ``csrc/`` into shared libraries loaded with ctypes.

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into the ignored ``_build/`` directory, keyed by a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags.  :func:`build` starts every missing
compile at once and waits for all of them, so several sources build in
parallel.  One library serves every card: a launch makes its tensor's card current
(``kernels/_launch``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NVCC_TIMEOUT_S = 600

_LOADED: Dict[Path, ctypes.CDLL] = {}
# one build at a time: host threads that launch at once (the placed sweep) compile once
_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Source:
    """One ``csrc/<name>.cu`` file and the flags it is compiled with."""

    name: str
    extra_flags: tuple = ()

    @property
    def path(self) -> Path:
        return PKG / "csrc" / f"{self.name}.cu"

    @property
    def flags(self) -> tuple:
        return NVCC_FLAGS + self.extra_flags

    def library_path(self) -> Path:
        """The library's path, keyed by the source, the shared headers and the flags."""
        text = self.path.read_bytes()
        for header in sorted(self.path.parent.glob("*.cuh")):
            text += header.read_bytes()
        digest = hashlib.sha256(text + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"{self.name}-{digest[:16]}.so"

    def log(self) -> str:
        """The compiler's output (ptxas register and spill report) of the build."""
        return self.library_path().with_suffix(".log").read_text()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _compile(src: Source) -> None:
    out = src.library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *src.flags, "-o", str(tmp), str(src.path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.path.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def build(*sources: Source) -> List[ctypes.CDLL]:
    """Compile the sources whose library is missing, all at once, and load them."""
    with _LOCK:
        return _build_locked(sources)


def _build_locked(sources) -> List[ctypes.CDLL]:
    missing = [s for s in sources if not (s.library_path() in _LOADED or s.library_path().exists())]
    if missing:
        with ThreadPoolExecutor(max_workers=len(missing)) as pool:
            list(pool.map(_compile, missing))
    libs = []
    for src in sources:
        out = src.library_path()
        if out not in _LOADED:
            _LOADED[out] = ctypes.CDLL(str(out))
        libs.append(_LOADED[out])
    return libs
