"""Build a CUDA source of this package into a shared library and load it.

Each ``csrc/*.cu`` file exports a plain C interface; ``nvcc`` compiles it
for ``sm_90a`` into ``build/kernels/`` beside the package at first use, and
``ctypes`` loads the result. The library name carries a hash of the source
and flags, so an edited source builds anew and a stale build is never
loaded. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded = {}
build_seconds = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def load_library(source_name):
    """ctypes handle of ``csrc/<source_name>``, built on first use."""
    with _lock:
        if source_name in _loaded:
            return _loaded[source_name]
        source = CSRC_DIR / source_name
        digest = hashlib.sha256(
            source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        target = BUILD_DIR / f"{source.stem}-{digest}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            start = time.perf_counter()
            # Build into a private name, then rename: concurrent builders
            # never load a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                result = subprocess.run(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)],
                    capture_output=True, text=True,
                )
                if result.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {source_name} "
                        f"(exit {result.returncode}):\n{result.stderr}"
                    )
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            build_seconds[source_name] = time.perf_counter() - start
        lib = ctypes.CDLL(str(target))
        _loaded[source_name] = lib
        return lib
