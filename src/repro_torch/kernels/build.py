"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the source, the shared header and the flags, so an edited source is rebuilt
and an unchanged one is reused.  ``build()`` starts one ``nvcc`` per missing
source, all at once, and waits for every one of them.

Nothing is built or loaded at import: the first launch on a CUDA tensor
builds what it needs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("layernorm", "softmax_entropy", "af_matmul", "span_attention", "af_quantize", "block_sparse",
           "span_attention_long")
HEADERS = ("common.cuh", "split_mma.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes argument kinds for the launchers' signatures
PTR, INT, INT64, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_LIBS: Dict[str, ctypes.CDLL] = {}   # loaded libraries, by kernel name


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the library (``-Xptxas -v``: registers, spills)."""
    return lib_path(name).with_suffix(".log")


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every library in ``names`` that is not built yet; returns the
    wall seconds.  Raises with nvcc's output if any compile fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    try:
        for name in todo:
            tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
            with open(log_path(name), "w") as log:
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs.append((name, tmp, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, tmp, proc in procs:
            if proc.wait() != 0:
                failed.append(name)
            else:
                os.replace(tmp, lib_path(name))
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        logs = "\n".join(f"--- {n}\n{log_path(n).read_text()[-4000:]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


_RESOURCE_PATTERNS = (("registers", r"Used (\d+) registers"), ("spill_stores", r"(\d+) bytes spill stores"),
                      ("spill_loads", r"(\d+) bytes spill loads"), ("static_smem", r"(\d+) bytes smem"))


def _largest(text: str) -> dict:
    return {key: max((int(v) for v in re.findall(pat, text)), default=0) for key, pat in _RESOURCE_PATTERNS}


def resources(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Per built kernel library, from nvcc's ``-Xptxas -v`` log: registers,
    spill stores and loads (bytes) and static shared memory (bytes), the
    largest over the library's kernels, the same for each kernel instance
    by its (mangled) name under ``functions``, and the dynamic shared
    memory its launcher asks for where the library exports it
    (``repro_smem_bytes``)."""
    out = {}
    for name in names:
        text = log_path(name).read_text()
        r = _largest(text)
        chunks = text.split("Compiling entry function '")[1:]
        r["functions"] = {c.split("'", 1)[0]: _largest(c) for c in chunks}
        fn = getattr(ctypes.CDLL(str(lib_path(name))), "repro_smem_bytes", None)
        if fn is not None:
            fn.argtypes, fn.restype = [], ctypes.c_int
            r["dynamic_smem"] = fn()
        out[name] = r
    return out


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (built on first use), with the
    argument types of its launchers set; every launcher returns an int
    CUDA error code.  After the first call this is one dictionary lookup,
    and ``lib.<launcher>`` an attribute read (ctypes keeps the function)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError after the
    launch, or a failed set-up call before it)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# PyTorch's raw current-stream query (an int, no Stream object), where this
# PyTorch build has it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer int."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def cluster_split(blocks: int, k_steps: int, slots: int) -> int:
    """How many blocks of a cluster share one output tile's K (split_mma.cuh).

    ``blocks`` is the grid without a split, ``k_steps`` the k-steps (or
    occupied tiles) one output tile walks, ``slots`` the blocks the card
    holds at once.  The split doubles, up to 8 (the portable cluster size),
    while the grid still fits in ``slots`` and every block keeps a k-step:
    a grid that fills the card is not split, since a split adds a reduction
    and fills no idle SM."""
    split = 1
    while split < 8 and blocks * split * 2 <= slots and split * 2 <= k_steps:
        split *= 2
    return split


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record through one of ``tensors``: grad mode
    is on and one of them requires grad.  No kernel has a backward (none of
    the Pallas kernels has one either), so a launch on such an input would
    return a result with no ``grad_fn`` and silently cut the graph."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require_cuda(what: str, *tensors: torch.Tensor, dtype=torch.float32, contiguous: bool = True) -> int:
    """Validate what the kernel takes (CUDA, one device, contiguous where
    ``contiguous``, ``dtype`` unless None, nothing autograd would record
    through: ``needs_grad``) with attribute reads only; returns the device
    index.  Training takes the reference ops (``use_kernels=False``)."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{what}: an input requires grad with grad enabled, and the kernel has no "
                           "backward; run the reference ops (use_kernels=False) or under torch.no_grad()")
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{what}: all inputs must be on one CUDA device, got {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    return dev
