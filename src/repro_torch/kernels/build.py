"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by hand with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` — seconds per
source, against minutes for an extension that includes PyTorch's headers.
Builds happen at first use, one ``nvcc`` per source, all started together,
into ``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``). A library's file name carries a hash of its source, so an
edited source (or shared ``*.cuh`` or ``*.h`` header) is rebuilt and an
unchanged one is reused.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after its launches; ``check`` raises on
a nonzero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("fused_cat_matmul", "paged_attention", "decode_layer",
           "block_matmul", "hadamard", "dynamic_quant", "quant_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(
        [*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all in parallel. Returns {name: {"s":
    seconds, "log": compiler output}} for the sources compiled now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"s": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), with ``argtypes``
    set from ``signatures`` {function: [ctypes types]} and int returns."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def off_card(x, name: str) -> bool:
    """True for a CPU tensor (the caller runs its plain version), False
    for a CUDA one (it launches its kernel); raises for any other
    device."""
    if x.device.type == "cpu":
        return True
    if not x.is_cuda:
        raise TypeError(f"{name} runs its kernel on CUDA tensors and its "
                        f"plain version on CPU tensors, got {x.device}")
    return False


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of the CUDA ``device`` (a ``torch.device`` or an index)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a ``void*`` argument (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a ``void*``."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
