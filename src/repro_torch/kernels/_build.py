"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into one shared library with
a plain C interface.  The library's name carries a hash of the sources and
flags, so a changed source is rebuilt and an unchanged one is loaded as it
is.  The build goes to ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``).  A failed build raises with nvcc's output;
nothing falls back.

Nothing here runs at import time: the library is built and loaded by the
first kernel launch (``library()``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_STEM = "librepro_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
COMPILE_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported function: name -> (argtypes, restype)
SIGNATURES = {
    "taskbench_compute_launch": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "taskbench_empty_launch": ([_I, _I, _P], _I),
    "taskbench_memory_launch": ([_P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
                                _I),
    "taskbench_fused_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P], _I),
    "taskbench_fused_blocks": ([_I, _I, _I], _I),
    "taskbench_onesided_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                                   _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _P], _I),
    "taskbench_onesided_blocks": ([_I], _I),
    "ssd_chunked_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P], _I),
    "ssd_chunked_smem_bytes": ([_I, _I, _I], _I),
    "ssd_chunked_bf16_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "ssd_chunked_bf16_smem_bytes": ([_I, _I], _I),
    "ssd_decode_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _L, _L, _L, _L, _I, _I, _I, _P], _I),
    "flash_attention_f32_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _F, _I, _I, _I, _I, _I, _P], _I),
    "flash_attention_bf16_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _F, _I, _I, _I, _I, _I, _P], _I),
    "flash_attention_f32_smem_bytes": ([_I], _I),
    "flash_attention_bf16_smem_bytes": ([_I], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    """Hash of every source, header and flag that goes into the library."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"{LIB_STEM}-{source_digest()}.so"


def log_path() -> Path:
    return BUILD_DIR / f"{LIB_STEM}-{source_digest()}.log"


def find_nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {home / 'bin'} and on PATH): the "
            f"CUDA kernels cannot be built")
    return found


def _run(cmd: List[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the library if this digest has not been built; return it."""
    lib = library_path()
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    # objects of this process only: a concurrent build cannot clobber them
    objdir = BUILD_DIR / f"obj-{source_digest()}-{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    try:
        srcs = sources()
        objs = [objdir / f"{src.stem}.o" for src in srcs]
        cmds = [[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(srcs, objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        tmp = objdir / lib.name
        logs.append(_run([nvcc, ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)]))
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    log_path().write_text("\n".join(logs))
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
