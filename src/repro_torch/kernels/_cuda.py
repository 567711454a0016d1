"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` of the checkout at first
use (``-shared -Xcompiler -fPIC``; no PyTorch headers, so a build takes
seconds), then loaded with ``ctypes``. The library name carries a digest of
the sources, so an edited kernel is rebuilt and a stale one is never loaded.
Nothing here runs at import time: the CPU tests import every module.

Every wrapper also has a shape-only face for a trace under
``FakeTensorMode`` (the dry run, ``launch/dryrun.py``): given a fake CUDA
tensor (:func:`is_fake`) it checks the operands as a launch would and
returns empty outputs with the kernel's shapes, dtypes and strides,
allocating its split-KV workspace or backward scratch as the launch does,
and reaches no library, stream, ticket or launch counter. Real launches
and faces alike report each call's FLOPs and bytes to the accountants in
:data:`ACCOUNTANTS` (the dry run's counting mode), from shapes alone, so a
real step and its fake trace count the same.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# name -> loaded library; name -> nvcc's stderr (ptxas register/spill report)
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built from csrc/ at first use on a GPU host")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every missing library among ``names``, all nvcc processes
    started together. Returns seconds per library built (0.0 when it was
    already there); raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = _target(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise for a non-zero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``device``, read
    through torch's accessor for it (a tenth of a microsecond; building a
    ``torch.cuda.Stream`` object takes several)."""
    return torch._C._cuda_getCurrentRawStream(_index(device))


_SM_COUNT: Dict[int, int] = {}     # device index -> SM count
# the SMs of an H100 SXM: what a shape-only face plans its split-KV
# workspace for when the trace runs on a host without a card
H100_SM_COUNT = 132

# fn(entry, flops, nbytes), called at every kernel launch and face
ACCOUNTANTS: List[Callable[[str, float, float], None]] = []


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor of a shape-only trace: the wrapper
    then runs its kernel's face and launches nothing."""
    return isinstance(t, FakeTensor)


def account(entry: str, flops: float, nbytes: float) -> None:
    """Report one kernel call's FLOPs and bytes (inputs read once, outputs
    written once) to every accountant."""
    for fn in ACCOUNTANTS:
        fn(entry, flops, nbytes)


def face_sm_count(device) -> int:
    """The SM count a face plans with: the card's, or the H100's on a host
    without one (a dry run traces on any host)."""
    return sm_count(device) if torch.cuda.is_available() else H100_SM_COUNT
_TICKETS: Dict[tuple, torch.Tensor] = {}   # (device index, stream) -> tickets


def _index(device) -> int:
    """The ordinal of a torch CUDA device ("cuda" is the current one)."""
    return torch.cuda.current_device() if device.index is None \
        else device.index


def sm_count(device) -> int:
    """The SM count of ``device`` (a torch device), read once."""
    index = _index(device)
    n = _SM_COUNT.get(index)
    if n is None:
        n = _SM_COUNT[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return n


def tickets(device, stream: int, n: int) -> torch.Tensor:
    """The merge tickets of (device, stream) that the split-KV decode
    kernels take, one per (sequence, kv head), allocated zeroed once and
    grown when a call needs more. Each kernel leaves every ticket it uses
    at 0 and launches on one stream run in order, so the kernels of a
    stream share the array; another stream gets its own. A stream being
    captured into a CUDA graph must have its tickets set up before the
    capture (:func:`private_tickets`)."""
    key = (_index(device), stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a split-KV decode kernel under CUDA graph capture needs "
                f"{n} merge tickets set up before the capture "
                f"(private_tickets)")
        t = _TICKETS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                        device=device)
    return t


def split_scratch(device, stream: int, pairs: int, splits: int,
                  floats_per_split: int):
    """(workspace, tickets) of a split-KV decode launch over ``pairs``
    (sequence, kv head) pairs, or (None, None) for one split: an fp32
    workspace of ``floats_per_split`` per split of every pair (each
    split's (acc, m, l) partial) from the caching allocator, and the
    stream's tickets (:func:`tickets`)."""
    if splits == 1:
        return None, None
    ws = torch.empty(pairs * splits * floats_per_split, dtype=torch.float32,
                     device=device)
    return ws, tickets(device, stream, pairs)


@contextlib.contextmanager
def private_tickets(device, stream: int, n: int):
    """Merge tickets owned by one CUDA graph: a zeroed array of at least
    ``n`` allocated now, before the graph is captured on ``stream``, and
    handed to every launch captured there; yields it (the graph keeps it
    alive). Its kernels reset each ticket they use, so every replay finds
    them zero; no eager call on another stream shares the array."""
    key = (_index(device), stream)
    prev = _TICKETS.get(key)
    t = _TICKETS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                    device=device)
    try:
        yield t
    finally:
        if prev is None:
            _TICKETS.pop(key, None)
        else:
            _TICKETS[key] = prev
