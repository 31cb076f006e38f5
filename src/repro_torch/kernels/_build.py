"""Build and load the Hopper kernels (``src/repro_torch/csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes`: every ``.cu``
becomes an object file in its own ``nvcc`` process (all started at once),
then one link step makes ``librepro_torch_kernels.so``.  The build runs at
first use into ``build/repro_torch_kernels/<hash>/`` at the repository root
(listed in ``.gitignore``); the hash covers the sources and the flags, so
an edited source rebuilds and an unchanged tree reuses the library.

``-fmad=false`` forbids multiply-add contraction and nvcc's default
``-prec-div=true`` keeps float division IEEE-rounded: together they let
each control-loop and VLD kernel's float results match its plain PyTorch
version bitwise.  The model kernels (attention, SwiGLU) are held to
tolerances instead and ask for their multiply-adds explicitly (``fmaf``,
``mma.sync``), so the flag does not halve their inner loops.

Nothing here runs at import time (the package must import on hosts with
neither ``nvcc`` nor a GPU).  :data:`LAUNCHES` counts kernel launches by
kernel name; each wrapper calls :func:`count_launch` where it launches, and
nowhere else.  The count takes a lock: the live engine's worker threads
launch kernels concurrently, and a bare ``Counter`` increment is a
read-modify-write that loses counts between threads.
"""

from __future__ import annotations

import collections
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["LAUNCHES", "SOURCES", "NVCC_FLAGS", "build", "library", "check_error",
           "count_launch", "column_slice"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("queue_step.cu", "erlang_c.cu", "gain_topr.cu", "decide_fused.cu", "l2_match.cu",
           "flash_attention.cu", "decode_attention.cu", "swiglu.cu", "rwkv6_scan.cu",
           "ssd_scan.cu")
HEADERS = ("common.cuh", "tensor_core.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)
LIB_NAME = "librepro_torch_kernels.so"

#: Kernel launches per kernel name since the last ``LAUNCHES.clear()``.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to :data:`LAUNCHES` (thread-safe)."""
    with _count_lock:
        LAUNCHES[name] += 1


def build_root() -> pathlib.Path:
    """``build/repro_torch_kernels`` at the repository root."""
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME / /usr/local/cuda); "
            "the repro_torch CUDA kernels build with the CUDA toolkit"
        )
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path.  Raises with nvcc's output on any failure."""
    root = build_root()
    final = root / _digest()
    lib_path = final / LIB_NAME
    if lib_path.exists():
        return lib_path
    root.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp-", dir=root))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (pathlib.Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs = []
        for name, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"--- {name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
                *(str(obj) for _n, obj, _p in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        if verbose:
            print("".join(logs), flush=True)
        try:
            os.replace(tmp, final)
        except OSError:  # another process finished the same build first
            if not lib_path.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library():
    """The loaded kernel library (built on first call), with C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            import ctypes

            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            ll = ctypes.c_longlong
            sigs = {
                "repro_queue_step": [p] * 7 + [i, i, p],
                "repro_queue_window": [p] * 9 + [i] * 6 + [p],
                "repro_erlang_b_table": [p, p, i, i, i, p],
                "repro_gain_topr": [p, p, p, p, i, i, i, i, i, i, p],
                "repro_decide_fused": [p] * 11 + [i] * 7 + [p],
                "repro_pairwise_sq_l2": [p, p, p, i, i, i, i, i, p],
                "repro_match_count": [p, p, p, f, p, i, i, i, i, i, p],
                "repro_flash_attention": [p] * 4 + [ll] * 12 + [i] * 6 + [f] + [i] * 4 + [p],
                "repro_decode_attention": [p] * 7 + [i] * 6 + [f] + [i] * 3 + [p],
                "repro_swiglu_up": [p] * 5 + [i] * 7 + [p],
                "repro_swiglu_down": [p] * 4 + [i] * 7 + [p],
                "repro_rwkv6_scan": [p] * 8 + [ll] * 17 + [i] * 10 + [p],
                "repro_ssd_scan": [p] * 7 + [ll] * 15 + [i] * 10 + [p],
            }
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i
            lib.repro_decode_attention_blocks_per_sm.argtypes = [i] * 4 + [ctypes.POINTER(i)]
            lib.repro_decode_attention_blocks_per_sm.restype = i
            lib.repro_gain_topr_work_ints.argtypes = [i, i]
            lib.repro_gain_topr_work_ints.restype = ll
            _lib = lib
        return _lib


def check_error(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {code}")


def require(name: str, t, dtype, shape=None, *, device=None) -> None:
    """The wrappers' input contract: a contiguous CUDA tensor of exactly
    ``dtype`` (no silent casts), ``shape`` when given, on ``device``."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_operands(name: str, tensors) -> bool:
    """The model kernels' input contract: CUDA tensors on one device, all
    bfloat16 or all float32 (no silent casts); True for bfloat16."""
    import torch

    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, got {t.device}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: expected bfloat16 or float32, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
    return dtype == torch.bfloat16


def column_slice(streams: int, cols: int, device) -> int:
    """Columns per block of a scan kernel (``csrc/{rwkv6,ssd}_scan.cu``):
    the widest power of two up to 64 dividing ``cols``, halved (not below
    16) while ``streams`` blocks per slice leave the card under two
    blocks per SM.  The columns of a scan's state evolve independently,
    so the slice changes the launch shape, not the result."""
    import torch

    vb = 64
    while cols % vb:
        vb //= 2
    sms = sm_count(torch.device(device).index or 0)
    while vb > 16 and streams * (cols // vb) < 2 * sms:
        vb //= 2
    return vb


_sms: dict = {}


def sm_count(device: int) -> int:
    """The card's SM count (cached per device index)."""
    if device not in _sms:
        import torch

        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def launch_args(t) -> tuple[int, int]:
    """(device index, current stream handle) for a CUDA tensor."""
    import torch

    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream  # an int index: half the cost
