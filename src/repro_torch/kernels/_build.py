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

Every wrapper of a hand-written kernel (K1-K7) registers here with
``kernel``, under its K-id in ``KERNELS``, and launches through
``launch``; ``runs_plain`` decides which devices run its plain version.
What counts launches (``launch_counts``, ``reset_launches``) reads the
registry, so a new kernel touches its own module, its ``csrc/`` source and
``SIGNATURES``, and no reader of the counts.
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
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ._cost import costed

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


# every registered kernel wrapper by its K-id
KERNELS: Dict[str, Callable] = {}


def kernel(kid: str, cost: Callable, what: str,
           plain_on: Iterable[str] = ("cpu",), wide: bool = False):
    """Register a kernel wrapper under ``kid``: it is ``costed(cost)``,
    counts its launches in ``.launches`` (and, where ``wide``, those on the
    16-byte path in ``.wide_launches``), runs its plain version on the
    devices of ``plain_on`` and raises that it has no ``what`` kernel on a
    device that is neither those nor CUDA (``runs_plain``)."""
    def wrap(fn):
        call = costed(cost)(fn)
        call.what, call.plain_on = what, frozenset(plain_on)
        call.launches = 0
        if wide:
            call.wide_launches = 0
        KERNELS[kid] = call
        return call

    return wrap


def runs_plain(kid: str, device: torch.device) -> bool:
    """Whether the wrapper of ``kid`` runs its plain version on ``device``
    (False: it launches its kernel, on a CUDA device)."""
    fn = KERNELS[kid]
    if device.type in fn.plain_on:
        return True
    if device.type != "cuda":
        raise ValueError(f"no {fn.what} kernel for device {device}")
    return False


def launch(kid: str, entry: str, *args, device: torch.device,
           wide: Optional[bool] = None) -> None:
    """Call the library's ``entry`` with ``args``, the device's index and
    its current stream; raise on a CUDA error under the name of ``kid``'s
    wrapper; count the launch in its ``launches`` (and ``wide`` in its
    ``wide_launches``)."""
    err = getattr(library(), entry)(
        *args, device.index, torch.cuda.current_stream(device).cuda_stream)
    fn = KERNELS[kid]
    check(err, fn.__name__)
    fn.launches += 1
    if wide is not None:
        fn.wide_launches += wide


def launch_counts(since: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The registered kernels' launches by K-id: since the last
    ``reset_launches``, or since ``since`` (an earlier ``launch_counts()``).
    A kernel whose count did not move is absent."""
    since = since or {}
    return {kid: fn.launches - since.get(kid, 0)
            for kid, fn in KERNELS.items()
            if fn.launches != since.get(kid, 0)}


def reset_launches() -> None:
    """Zero every registered kernel's ``launches``."""
    for fn in KERNELS.values():
        fn.launches = 0
