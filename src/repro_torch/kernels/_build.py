"""Build and bind the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and bound with ``ctypes`` (pointers and the stream
as ``c_void_p``).  The build happens at first use, every source at once
(one ``nvcc`` process each, started together), into ``build/kernels/`` at
the root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), and is
cached by a hash of the source and the flags.  A missing ``nvcc``, a failed
build and a failed launch raise; nothing falls back to the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("hash_mix", "bucket_dedup", "nested_join", "scan_join")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # wall time of each nvcc run this process


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "CUDA kernels of repro_torch are built from source at first use"
        )
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _build_missing(names) -> None:
    """Compile every library in ``names`` that is not cached, in parallel."""
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name, target in todo:
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, target, tmp, t0, proc in procs:
        out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))


def _bind(name: str, lib: ctypes.CDLL) -> None:
    P, I, LL, ULL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    lib.kernel_error_string.argtypes = [I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    if name == "hash_mix":
        lib.hash_mix_launch.argtypes = [P, I, LL, ULL, P, P, P, I]
        lib.hash_mix_launch.restype = I
    elif name == "bucket_dedup":
        lib.bucket_dedup_launch.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, P, I]
        lib.bucket_dedup_launch.restype = I
        lib.bucket_dedup_ctas_per_sm.argtypes = [I, I, I]
        lib.bucket_dedup_ctas_per_sm.restype = I
    elif name == "nested_join":
        lib.nested_join_launch.argtypes = [P, P, P, LL, LL, I, I, P, P, P, I]
        lib.nested_join_launch.restype = I
    else:
        lib.scan_join_launch.argtypes = [
            ctypes.POINTER(ULL), I, ctypes.POINTER(I), I, I, LL, P, I]
        lib.scan_join_launch.restype = I


def load_all() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library."""
    with _lock:
        missing = [n for n in KERNELS if n not in _libs]
        if missing:
            _build_missing(missing)
            for name in missing:
                lib = ctypes.CDLL(str(_target(name)))
                _bind(name, lib)
                _libs[name] = lib
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    return lib if lib is not None else load_all()[name]


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when the cached library was built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
