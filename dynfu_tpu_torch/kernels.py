"""Build, load and launch the hand-written CUDA kernels in csrc/.

All csrc/*.cu files compile with nvcc into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds): one nvcc per source, all started together, then one link. The
build runs at the first launch in a process, from the sources in this
checkout only, into <repo>/build/kernels/; the library's name carries a hash
of the sources and flags, so an edited source is never served by a stale
build. Nothing here runs at import: the CPU tests import every module on
machines without nvcc.

Every C entry point enqueues its kernels on the stream it is given and
returns cudaGetLastError(); `check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# -fmad=false: the plain PyTorch versions round every product and sum
# separately, and the k-NN selections must agree with them bit for bit, so
# the compiler may not contract a*b+c into an FMA.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points: name -> argument types (every pointer and the stream are
# c_void_p, so ctypes never truncates a 64-bit address)
SIGNATURES = {
    "dynfu_pack_triangles": [_P, _P, _P, _I, _I, _P, _P],
    "dynfu_knn_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "dynfu_warp_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P],
    "dynfu_monomial_grams": [_P, _P, _P, _P, _P, _I, _I, _I,
                             _P, _P, _P, _P],
    "dynfu_nn1_window": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P, _P, _P],
    "dynfu_data_normal": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "dynfu_fetch_stencil": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libdynfu_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands concurrently; raise on the first failure."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    failed = []
    for c, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu into the shared library (if not built yet)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc, *compile_flags, "-I", str(CSRC), "-c",
                         str(src), "-o", obj])
        _run(cmds)
        tmp = os.path.join(tmpdir, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.dynfu_error_string.argtypes = [ctypes.c_int]
        lib.dynfu_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = load().dynfu_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Validate one kernel argument before its pointer is handed to C."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """Dispatch rule shared by every wrapper: True launches the kernel,
    False runs the plain version (CPU tensors only); anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {t.device}")


def count_plain(plain_fn, t: torch.Tensor) -> None:
    """Count a plain-version call on a CUDA tensor (chip_smoke.py compares
    kernels with their plain versions this way; the main path never
    should)."""
    if t.device.type == "cuda":
        plain_fn.cuda_calls += 1
