"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` (the kernels of ``KERNEL_SOURCES``, and the host
code of ``HOST_SOURCES``: the PNG decoder's row unfilter) exposes a plain C
interface and is compiled by ``nvcc`` into its own shared library, loaded
with ``ctypes``. Nothing here
runs at import time: the first wrapper call that needs a kernel builds it
(``build_all`` builds every source at once, one ``nvcc`` process per source,
all started together). Libraries go to ``objectdetection_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false``: the NMS,
ROIAlign, anchor-match, fused-block, int8-conv, conv-epilogue and
ROIAlign-probe kernels must reproduce their plain PyTorch versions bit for
bit, and a multiply-add contracted into an FMA rounds once where PyTorch
rounds twice.

The launch seam: a wrapper declares each C entry it calls once, as an
:class:`Entry` (library, symbol, argument types), and launches it with
:meth:`Entry.launch` on the tensors' device and that device's current
stream; the symbol is resolved and typed on first use, the returned status
checked, and the launch counted in one tally keyed by kernel name
(:func:`launches`; the plain versions never count). :func:`takes_kernel` is
the wrappers' device rule: the kernel for a CUDA tensor, the plain version
for a CPU one, and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNEL_SOURCES = ("anchor_match", "conv_epilogue", "fused_block", "int8_conv", "nms", "roi_align",
                  "roi_probes")
HOST_SOURCES = ("png_unfilter",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_tally: Dict[str, int] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    common = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + common + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: List[str] | None = None) -> Dict[str, str]:
    """Compile every missing kernel library in parallel; returns the ptxas
    report (registers, shared memory, spills) of each source it compiled."""
    names = list(names or KERNEL_SOURCES + HOST_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def takes_kernel(t: torch.Tensor, what: str) -> bool:
    """The device rule of every kernel wrapper: True for a CUDA tensor (the
    kernel), False for a CPU one (the plain version); raises for any other
    device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def launches(*names: str):
    """Kernel launches so far: the whole tally as a dict, or the sum over
    ``names``."""
    if not names:
        return dict(_tally)
    return sum(_tally.get(n, 0) for n in names)


class Entry:
    """One C entry point of ``csrc/<lib>.cu``, declared once by its wrapper.

    ``argtypes`` lists its arguments, without the CUDA stream that a kernel
    entry takes last (:meth:`launch` appends it; ``stream=False`` for host
    code, called through :attr:`fn`); ``result`` is its return type;
    ``name`` is the kernel's name in the launch tally (default: the symbol).
    Nothing is built or loaded until the first call."""

    def __init__(self, lib: str, symbol: str, argtypes: Sequence, name: Optional[str] = None,
                 result=ctypes.c_int, stream: bool = True):
        self.lib, self.symbol, self.name = lib, symbol, name or symbol
        self.argtypes = list(argtypes) + ([ctypes.c_void_p] if stream else [])
        self.result = result
        self._fn = None

    @property
    def fn(self):
        """The library's symbol, its argument and result types set once."""
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, self.result
            self._fn = fn
        return self._fn

    def launch(self, device, *args, on_status: Optional[Callable[[int], None]] = None) -> None:
        """Call the entry on ``device`` and its current stream; a nonzero
        status raises, naming the symbol (``on_status`` may raise its own
        message first), and the launch is tallied."""
        device = torch.device(device)
        with torch.cuda.device(device):
            status = self.fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if on_status is not None:
            on_status(status)
        check(status, self.symbol)
        _tally[self.name] = _tally.get(self.name, 0) + 1
