"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, and loaded with ``ctypes``.  The build
happens at first use, into ``build/kernels/`` at the repository root, with
one ``nvcc`` per source, all started together, under a file lock
(``build/kernels/.lock``), so ranks that start together build once.  A
library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused.  Nothing here runs at import time: importing the
package on a host without ``nvcc`` works, and only a CUDA launch builds.

``LAUNCHES`` counts kernel launches by kernel name: ``flash_fwd`` (kernel
A), ``flash_bwd_dq`` and ``flash_bwd_dkv`` (kernels C and D) each count one
route or another, ``flash_fwd_sm90.cu`` / ``flash_bwd_sm90.cu`` for bf16
and ``flash_fwd.cu`` / ``flash_bwd.cu`` for float32 at one head dim, and at
materialised MLA's q/k 192 and v 128 ``flash_bwd_pair_sm90.cu`` for bf16
and ``flash_bwd.cu``'s <192, 128> for float32; ``flash_fwd_latent``
counts kernel A's latent route at MLA's q/k 576 and v 512, again one of
two by dtype (``flash_fwd_latent_sm90.cu`` for bf16,
``flash_fwd_latent.cu`` for float32), ``flash_fwd_pair`` its pair route at
materialised MLA's q/k 192 and v 128 (``flash_fwd_pair_sm90.cu`` for bf16,
``flash_fwd_latent.cu``'s <192, 128> for float32), ``flash_fwd_160``,
``flash_bwd_dq_160`` and ``flash_bwd_dkv_160`` kernels A, C and D at head
dim 160 (the pair libraries' <160, 160> for bf16, ``flash_fwd.cu`` and
``flash_bwd.cu`` for float32), and ``paged_decode`` kernel B; each
wrapper adds one where it launches its kernel, and nowhere else.  Headers
(``csrc/*.cuh``) are part of every source's hash.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("flash_fwd", "paged_decode", "flash_bwd",        # sources
           "flash_bwd_sm90", "flash_fwd_sm90", "flash_fwd_latent",
           "flash_fwd_latent_sm90", "flash_fwd_pair_sm90",
           "flash_bwd_pair_sm90")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "flash_fwd", "paged_decode", "flash_bwd_dq", "flash_bwd_dkv",
    "flash_fwd_latent", "flash_fwd_pair", "flash_fwd_160",
    "flash_bwd_dq_160", "flash_bwd_dkv_160")}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    """``build/kernels`` at the repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "host with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{h}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, in parallel.
    Returns nvcc's output (with ptxas' register and spill report) for every
    kernel, kept beside each library as ``.log``; raises with that output
    on failure."""
    build_dir().mkdir(parents=True, exist_ok=True)
    with _LOCK, open(build_dir() / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = {n: _target(n) for n in KERNELS if not _target(n).exists()}
        if todo:
            nvcc = _nvcc()
            procs = {}
            for name, out in todo.items():
                tmp = out.with_suffix(f".tmp{os.getpid()}")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (tmp, out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, out, proc) in procs.items():
                text, _ = proc.communicate()
                if proc.returncode:
                    failed.append(f"--- nvcc {name}.cu (rc "
                                  f"{proc.returncode}) ---\n{text}")
                else:
                    out.with_suffix(".log").write_text(text)
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("kernel build failed:\n"
                                   + "\n".join(failed))
        logs = {n: _target(n).with_suffix(".log") for n in KERNELS}
        return {n: p.read_text() if p.exists() else ""
                for n, p in logs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def int64_args(*vals) -> ctypes.Array:
    """A host int64 array for a C entry point's ``const long long*``."""
    return (ctypes.c_longlong * len(vals))(*(int(v) for v in vals))


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
