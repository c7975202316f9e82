"""Native (C++) host code, built at first use: the OpenPose assembly tail.

The port of ``terran_tpu/native/__init__.py``. ``assembly.cpp`` (greedy
limb matching and human merging) has a plain C interface; ``g++`` builds
it at first use into ``build/native/`` beside the package, named by a hash
of the source and flags, and ``ctypes`` loads it. Where no compiler is
found or the build fails, :func:`native_available` is False and
``terran_tpu_torch.pose.assembly`` runs its Python version, which gives
the same humans (tested). ``TERRAN_TPU_NATIVE=0`` turns the library off.
Nothing here runs at import time.
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

import numpy as np

SOURCE = Path(__file__).resolve().parent / "assembly.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_state = {"tried": False, "lib": None, "build_s": None, "error": None}


def _build():
    """Path of the built library, running ``g++`` when it is not built
    yet (into a private name, then renamed, so that another process
    building at the same time never loads a half-written file)."""
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found on PATH")
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    target = BUILD_DIR / f"assembly-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([compiler, *GXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _bind(lib):
    lib.greedy_connections.restype = ctypes.c_int
    lib.greedy_connections.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.assemble_humans.restype = ctypes.c_int
    lib.assemble_humans.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return lib


def load():
    """The ctypes handle of the assembly library, or None when
    ``TERRAN_TPU_NATIVE=0`` or it cannot be built (:func:`build_error`
    says why). Built and loaded once per process."""
    if os.environ.get("TERRAN_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            start = time.perf_counter()
            try:
                _state["lib"] = _bind(ctypes.CDLL(str(_build())))
            except (OSError, RuntimeError,
                    subprocess.CalledProcessError) as error:
                detail = getattr(error, "stderr", "") or ""
                _state["error"] = f"{error}\n{detail}".strip()
            _state["build_s"] = time.perf_counter() - start
        return _state["lib"]


def native_available():
    return load() is not None


def build_seconds():
    """Seconds the first :func:`load` took (build included), or None."""
    return _state["build_s"]


def build_error():
    """Why the library could not be built or loaded, or None."""
    return _state["error"]


def _contiguous(array, dtype):
    return np.ascontiguousarray(array, dtype=dtype)


def greedy_connections_native(reg_scores, accept, count_src, count_dst):
    """C++ greedy matching for one limb; the contract of
    ``terran_tpu_torch.pose.assembly.greedy_connections``."""
    lib = load()
    k = reg_scores.shape[0]
    if reg_scores.shape != (k, k) or accept.shape != (k, k):
        raise ValueError(f"expected (k, k) tables, got {reg_scores.shape} "
                         f"and {accept.shape}")
    reg = _contiguous(reg_scores, np.float32)
    acc = _contiguous(accept, np.uint8)
    out = np.zeros((k, 3), dtype=np.float64)
    n = lib.greedy_connections(reg.ctypes.data, acc.ctypes.data, k,
                               int(count_src), int(count_dst),
                               out.ctypes.data)
    return out[:n]


def assemble_humans_native(peak_scores, counts, offsets, reg_scores, accept,
                           limbseq, starts, human_threshold=0.4,
                           max_humans=256):
    """C++ human assembly for one image -> the (n, P + 2) humans array in
    the reference layout (P = ``peak_scores``' parts: global peak ids or
    -1, then score sum, keypoint count). ``limbseq`` (L, 2) and
    ``starts`` (L,), which limbs may start a human, are a pose family's
    (``ops.pose_decode.Skeleton``)."""
    lib = load()
    num_limbs, k, _ = reg_scores.shape
    num_parts = peak_scores.shape[0]
    if (peak_scores.shape != (num_parts, k)
            or accept.shape != reg_scores.shape
            or len(counts) != num_parts or len(offsets) != num_parts
            or limbseq.shape != (num_limbs, 2)
            or np.shape(starts) != (num_limbs,)
            or int(np.max(limbseq)) >= num_parts
            or int(np.max(counts, initial=0)) > k):
        raise ValueError("inconsistent shapes for the assembly")
    ps = _contiguous(peak_scores, np.float32)
    cn = _contiguous(counts, np.int32)
    of = _contiguous(offsets, np.int32)
    rg = _contiguous(reg_scores, np.float32)
    ac = _contiguous(accept, np.uint8)
    ls = _contiguous(limbseq, np.int32)
    st = _contiguous(starts, np.uint8)
    out = np.zeros((max_humans, num_parts + 2), dtype=np.float64)
    n = lib.assemble_humans(
        ps.ctypes.data, cn.ctypes.data, of.ctypes.data, rg.ctypes.data,
        ac.ctypes.data, ls.ctypes.data, st.ctypes.data, num_parts,
        num_limbs, k, float(human_threshold), max_humans, out.ctypes.data,
    )
    return out[:n]
