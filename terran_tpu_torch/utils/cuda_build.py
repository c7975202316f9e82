"""Build CUDA sources of this package into shared libraries and load them.

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


def _target(source_name):
    source = CSRC_DIR / source_name
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return source, BUILD_DIR / f"{source.stem}-{digest}.so"


def load_libraries(*source_names):
    """ctypes handles of ``csrc/<name>`` for each name, built on first use:
    one ``nvcc`` for each source that is not built yet, all started
    together. ``build_seconds[name]`` is the time from their start until
    that source's build was seen to finish."""
    with _lock:
        builds = []
        start = time.perf_counter()
        try:
            for name in source_names:
                if name in _loaded:
                    continue
                source, target = _target(name)
                if target.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # Build into a private name, then rename: a concurrent
                # builder never loads a half-written library.
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                builds.append((name, target, tmp, subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True,
                )))
            for name, target, tmp, proc in builds:
                _, stderr = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name} "
                                       f"(exit {proc.returncode}):\n{stderr}")
                os.replace(tmp, target)
                build_seconds[name] = time.perf_counter() - start
        finally:
            for _, _, tmp, proc in builds:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        for name in source_names:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
        return [_loaded[name] for name in source_names]


def load_library(source_name):
    """ctypes handle of ``csrc/<source_name>``, built on first use."""
    return load_libraries(source_name)[0]
