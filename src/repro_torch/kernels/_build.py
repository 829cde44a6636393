"""Build, load and launch the hand-written Hopper kernels (csrc/*.cu).

Counterpart of repro.kernels.runtime: where the JAX package chose between
compiled Mosaic and the Pallas interpreter, the port has exactly one way to
run a kernel on a CUDA tensor — the nvcc-built shared library — and no
fallback.  The plain PyTorch versions beside each kernel serve CPU tensors
only (the device of the tensor decides, in each ops module).

At first use every `csrc/*.cu` source is compiled, one `nvcc` process per
source, all started together, for `sm_90a` into `<repo>/build/repro_torch/`
(listed in .gitignore).  Each library is named by a hash of its source, so
an edited kernel is rebuilt and an unchanged one is reused.  The libraries
expose a plain C interface and are loaded with ctypes (no torch headers, so
a build takes seconds, not minutes).

Every launch goes through `launch`: pointers from `Tensor.data_ptr()`, the
stream from `torch.cuda.current_stream()`, and the C function's return code
— `cudaGetLastError()` after its launches — checked and raised on.  The C
prototype of each (symbol, argument types) is set once and kept, so a launch
costs the host one pass over its arguments.

A process that has called `load_only()` (a rank of a distributed run)
loads the libraries its launcher built and never runs nvcc.

Each nvcc build and each library load is counted by source for the
compile and capture auditor (analysis.recompile: "build:<source>",
"load:<source>").

`LAUNCHES` counts kernel launches by wrapper name.  Each ops wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels (`reset_launches()` before, read after).
"flash_attention_tc" counts the tensor-core launches among "flash_attention"'s;
"flash_attention_bwd" and "wkv_bwd" the calls of the backward kernels
(each one C entry of three launches), "flash_attention_bwd_tc" the
tensor-core calls among "flash_attention_bwd"'s;
"probe_sweep_batched_per_trial" and "commit_sweep_batched_per_trial" the
batched launches with one agent per trial among theirs.
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
from typing import Dict, List

import torch

from repro_torch.analysis import recompile

__all__ = ["LAUNCHES", "KernelBuildError", "arrivals", "as_f32", "build_all",
           "build_log", "check_cuda_tensor", "launch", "load_only", "on_cpu",
           "query", "reset_launches", "sm_count"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
          "-lineinfo", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"gram": 0, "row_gram": 0, "probe_sweep": 0,
                            "commit_sweep": 0, "gram_batched": 0,
                            "row_gram_batched": 0, "probe_sweep_batched": 0,
                            "commit_sweep_batched": 0,
                            "probe_sweep_batched_per_trial": 0,
                            "commit_sweep_batched_per_trial": 0,
                            "flash_attention": 0,
                            "flash_attention_tc": 0, "flash_decode": 0,
                            "wkv": 0, "flash_attention_bwd": 0,
                            "flash_attention_bwd_tc": 0, "wkv_bwd": 0}


class KernelBuildError(RuntimeError):
    """nvcc is missing, a kernel failed to build, or the card cannot run it."""


_LOAD_ONLY = False


def load_only() -> None:
    """From now on this process loads the libraries and never builds one: a
    missing library raises.  The ranks of a distributed run call it, so D
    processes never run nvcc into one build directory at once (their
    launcher builds every library before it starts them)."""
    global _LOAD_ONLY
    _LOAD_ONLY = True


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the repro_torch CUDA kernels "
        "are compiled from src/repro_torch/csrc at first use")


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):   # shared helpers count too
        h.update(header.read_bytes())
    return _BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def _libraries() -> Dict[str, ctypes.CDLL]:
    """Compile (where not already built) and load every kernel library."""
    if not torch.cuda.is_available():
        raise KernelBuildError("no CUDA device: the kernels run on an sm_90 card")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise KernelBuildError(
            f"the kernels are built for sm_90a (Hopper); this card is "
            f"compute capability {cap[0]}.{cap[1]}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(src, _lib_path(src)) for src in _sources()]
    missing = [out.name for _, out in todo if not out.is_file()]
    if _LOAD_ONLY and missing:
        raise KernelBuildError(
            f"this process only loads kernel libraries, and {missing} are not "
            f"built in {_BUILD_DIR} (build them first: _build.build_all())")
    procs = []
    for src, out in todo:
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *_ARCH, *_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        recompile.record(f"build:{src.stem}")
    failed = []
    for src, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc={rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    libs = {}
    for src, out in todo:
        libs[src.stem] = ctypes.CDLL(str(out))
        recompile.record(f"load:{src.stem}")
    return libs


def build_all() -> float:
    """Build and load every kernel library now; returns the seconds taken."""
    t0 = time.perf_counter()
    _libraries()
    return time.perf_counter() - t0


def build_log() -> str:
    """ptxas register/shared-memory report of the current builds (the log of
    a library reused from an earlier build is that build's)."""
    parts = []
    for src in _sources():
        log = _lib_path(src).with_suffix(".log")
        if log.is_file():
            parts.append(f"== {src.name}\n{log.read_text()}")
    return "\n".join(parts)


def on_cpu(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA one
    (the kernel runs); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {t.device}")
    return t.device.type == "cpu"


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """The fp32 view the kernels read (a cast only if t is not fp32)."""
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def check_cuda_tensor(name: str, t: torch.Tensor, shape=None) -> None:
    """Raise unless `t` is a contiguous floating tensor on a CUDA device of
    the expected shape — what every kernel wrapper needs of its inputs."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if not t.dtype.is_floating_point:
        raise TypeError(f"{name}: expected a floating dtype, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_ARRIVALS: Dict = {}


def arrivals(device: torch.device, count: int) -> torch.Tensor:
    """At least `count` zeroed int32 arrival counters for the kernels whose
    last-arriving block sums the others' partials (row_gram, probe_sweep on
    its register route, commit_sweep), kept per device and current stream
    and grown on demand.  Every launch leaves them zero, and launches on one
    stream run one after another, so those kernels share them."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    have = _ARRIVALS.get(key)
    if have is None or have.numel() < count:
        have = torch.zeros(max(count, 64), dtype=torch.int32, device=device)
        _ARRIVALS[key] = have
    return have


def query(source: str, symbol: str, *args: int) -> int:
    """The int that host function `symbol` of the library built from
    csrc/<source>.cu returns for int `args` (a kernel's own constants)."""
    fn = getattr(_libraries()[source], symbol)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    return fn(*args)


@functools.lru_cache(maxsize=None)
def _function(source: str, symbol: str, types: tuple):
    """`symbol` of csrc/<source>.cu as a C function of `types` and then the
    stream, returning int: a function object of its own per prototype."""
    fn = _libraries()[source][symbol]
    fn.argtypes = [*types, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(source: str, symbol: str, *args) -> None:
    """Call `symbol` of the library built from csrc/<source>.cu with `args`
    (tensors by device pointer, None as a null pointer, ints, floats) on the
    current CUDA stream, and raise if the launch reports an error."""
    values, types = [], []
    for a in args:
        if a is None:
            values.append(None)
            types.append(ctypes.c_void_p)
        elif isinstance(a, torch.Tensor):
            if a.get_device() != 0:
                # the libraries' own CUDA runtime launches on device 0
                raise ValueError(f"{source}.{symbol}: the kernels run on cuda:0, got a "
                                 f"tensor on {a.device}")
            values.append(a.data_ptr())
            types.append(ctypes.c_void_p)
        elif isinstance(a, bool):
            raise TypeError("pass kernel flags as int or float, not bool")
        elif isinstance(a, int):
            values.append(a)
            types.append(ctypes.c_int)
        elif isinstance(a, float):
            values.append(a)
            types.append(ctypes.c_float)
        else:
            raise TypeError(f"unsupported kernel argument type {type(a).__name__}")
    if torch.cuda.current_device() != 0:
        raise ValueError(f"{source}.{symbol}: the kernels run on cuda:0, the current "
                         f"device is {torch.cuda.current_device()}")
    fn = _function(source, symbol, tuple(types))
    rc = fn(*values, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        lib = _libraries()[source]
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{source}.{symbol}: CUDA launch failed "
                           f"(error {rc}: {msg})")
