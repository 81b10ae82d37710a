"""Build, load and launch the hand-written CUDA kernels of ``repro_torch/csrc``.

The sources have a plain C interface and are bound with ``ctypes``: each
``.cu`` file is compiled by its own ``nvcc`` (all started together) for
``sm_90a``, and the objects are linked into one shared library under
``<repo>/build/kernels/<hash>/``. The hash covers the sources and the flags,
so an edited source rebuilds at first use and an unchanged tree reuses the
library. Nothing here runs at import time: the first kernel launch builds.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers in :mod:`repro_torch.kernels` raise :class:`KernelLaunchError` when
it is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("int_compress.cu", "wire_pack.cu", "fused_update.cu", "block_norms.cu")
# --fmad=false: the kernels round every product before its sum, as their
# plain PyTorch versions do, so integer outputs and the fused update agree
# with them bit for bit on the card.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# C signature of every entry point (all return int: cudaGetLastError())
SIGNATURES = {
    "repro_int_compress": (_vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "repro_pack_words": (_vp, _vp, _i64, _i64, _i32, _i32, _i32, _vp),
    "repro_unpack_words": (_vp, _vp, _i64, _i64, _i32, _i32, _i32, _vp),
    # words, p, mom, h, scalars, p', m', h', d, m, k, bits, nlim, stream
    "repro_fused_unpack_sgd": (
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32, _i32, _i32, _vp,
    ),
    # words, p, mu, nu, h, scalars, p', mu', nu', h', d, m, k, bits, nlim, stream
    "repro_fused_unpack_adamw": (
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32,
        _i32, _i32, _vp,
    ),
    # ints, lane bytes, p, mom, h, scalars, p', m', h', d, stream
    "repro_fused_apply_sgd": (
        _vp, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64, _vp,
    ),
    # ints, lane bytes, p, mu, nu, h, scalars, p', mu', nu', h', d, stream
    "repro_fused_apply_adamw": (
        _vp, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64, _vp,
    ),
    # x, dtype code, out, partials, ticket counters, numel, chunk, nblocks,
    # ctas, stream
    "repro_block_norms": (_vp, _i32, _vp, _vp, _vp, _i64, _i64, _i32, _i32, _vp),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "librepro_kernels.so"


def build(*, verbose: bool = False) -> Path:
    """Compile the sources (one nvcc each, in parallel) and link them into
    the shared library; return its path. A library already built from the
    same sources and flags is reused. With ``verbose`` the compiler's
    register and spill report (``-Xptxas -v``) is printed."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for name, _, proc in procs:
            log, _ = proc.communicate()
            if verbose and log.strip():
                print(f"[nvcc {name}]\n{log.rstrip()}")
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
        if failed:
            raise KernelBuildError("nvcc failed on " + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
                "-o", str(tmp_so)]
        r = subprocess.run(link, capture_output=True, text=True)
        if r.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or none
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call), with ``argtypes``
    and ``restype`` declared for every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if status != 0:
        raise KernelLaunchError(
            f"{kernel}: CUDA error {status} at launch "
            "(cudaGetLastError after the kernel call)"
        )


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``:
    what the CUDA kernels take, and nothing else."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} tensor on "
            f"{device}, got {t.dtype} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)")
        )


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
