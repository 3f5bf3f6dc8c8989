"""Build the port's CUDA kernels on first use and bind them with ctypes.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface. The library's name carries a hash
of the sources and flags, so an edited source builds anew and an unchanged
one is loaded from ``build/``. Nothing here runs at import time.

Every C entry point takes the CUDA stream as a pointer and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# per-source flags: AdamW must be bitwise equal to its plain version
SOURCES = {
    "fused_adamw.cu": ["-fmad=false"],
    "flash_attention.cu": [],
    "flash_attention_wgmma.cu": [],
    "flash_attention_bwd.cu": [],
    "bucket_pack.cu": [],
}
# headers the sources include: they enter the library's hash too
HEADERS = ("hopper.cuh",)

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ADAMW_ARGS = [_P, _P, _P, _P, _LL] + [_F] * 10 + [_P]
MAX_PACK_LEAVES = 128


class PackTable(ctypes.Structure):
    """One bucket-pack launch's leaves, passed by value (``PackTable`` in
    ``csrc/bucket_pack.cu``): source address, destination byte offset and
    byte count per leaf, and ``first``, the 16-byte chunk prefix sums."""
    _fields_ = [("src", ctypes.c_uint64 * MAX_PACK_LEAVES),
                ("dst", ctypes.c_uint64 * MAX_PACK_LEAVES),
                ("nbytes", ctypes.c_uint64 * MAX_PACK_LEAVES),
                ("first", ctypes.c_uint32 * (MAX_PACK_LEAVES + 1)),
                ("n", ctypes.c_int)]

SIGNATURES = {
    "repro_adamw_f32": _ADAMW_ARGS,
    "repro_adamw_bf16": _ADAMW_ARGS,
    "repro_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _F, _P],
    "repro_flash_fwd_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _F, _P],
    "repro_flash_bwd_wgmma": [_P] * 10 + [_I] * 8 + [_F, _P],
    "repro_bucket_pack": [PackTable, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None     # wall time of the build this process ran
ptxas_log: str = ""                    # nvcc's -Xptxas -v report of that build


class LaunchCounter:
    """Launches of one kernel; a wrapper adds one where it launches."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self):
        with self._lock:
            self.value += 1

    def reset(self):
        with self._lock:
            self.value = 0


# the step analyses listening (`repro_torch.launch.step_analysis`)
_work_sinks: list = []


def record_work(kernel: str, flops: float, nbytes: float):
    """A wrapper called on meta tensors reports the work its kernel would
    do (a meta tensor has no data to launch on): the FLOPs and the bytes
    it must move, to every step analysis that is listening."""
    for sink in _work_sinks:
        sink(kernel, flops, nbytes)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        h.update(" ".join(ARCH + COMMON + flags).encode())
    for name in HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile every source in parallel and link them; returns the .so path."""
    global build_seconds, ptxas_log
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"librepro_torch_{_digest()}.so"
    if lib.exists():
        return lib
    t0 = time.perf_counter()
    exe = nvcc()
    procs, objs = [], []
    for name, flags in SOURCES.items():
        obj = build_dir / (name + ".o")
        cmd = [exe, *ARCH, *COMMON, *flags, "-Xptxas", "-v", "-c",
               str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    logs, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = lib.with_suffix(".so.tmp")
    link = subprocess.run([exe, *ARCH, "-shared", *objs, "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp.replace(lib)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "\n".join(logs)
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
