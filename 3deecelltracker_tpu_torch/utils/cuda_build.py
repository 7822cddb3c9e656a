"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints and the
stream as ``void*``; every entry point returns ``cudaGetLastError()``), is
compiled for ``sm_90a`` into its own shared library, and is loaded once per
process; a source may include the shared headers beside it
(``csrc/*.cuh``).  Libraries are cached under ``_build/`` in the package
(listed in ``.gitignore``) by a digest of the source, the headers and the
flags, so a changed source or header never loads a stale build.  Beside
each library, ``ptxas``'s report of its kernels (``-Xptxas -v``: registers,
spills, static shared memory) is kept for :func:`resource_usage`.  Nothing
here runs at import time: the first kernel call builds.  The wrappers'
hot path goes through :func:`function`, :func:`raw_stream`,
:func:`sm_count` and :func:`resident_blocks`, which resolve once and take
no lock afterwards.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_n_sm: Dict[int, int] = {}
_resident: Dict[Tuple[str, str, int], int] = {}


def find_nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are compiled from csrc/ at first use")


def _library(name: str) -> Path:
    """Where the build of the current ``csrc/<name>.cu`` lives (the digest
    covers the shared headers, ``csrc/*.cuh``, too)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source
    exists; returns the library path.  The write is atomic (temp file +
    rename), so concurrent builders never load a half-written library."""
    out = _library(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        out.with_suffix(".ptxas.txt").write_text(res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence = ()):
    """The ctypes handle of ``symbol`` in ``csrc/<name>.cu``'s library,
    with ``argtypes`` and an int result, resolved at its first call and
    kept: later calls take no lock and set nothing."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def raw_stream(t) -> int:
    """The raw handle of the current stream of tensor t's card (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream object: for kernels short enough that their
    wrappers' host work shows)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def sm_count(device) -> int:
    """The card's streaming multiprocessors, asked once per device."""
    n = _n_sm.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _n_sm[device.index] = n
    return n


def resident_blocks(name: str, symbol: str, device) -> int:
    """The blocks of one kernel the whole card holds at once: ``symbol``
    of ``csrc/<name>.cu`` returns the blocks an SM holds (the occupancy
    API; a CUDA error as a negative number), times the SMs.  Asked once
    per device."""
    key = (name, symbol, device.index)
    n = _resident.get(key)
    if n is None:
        per_sm = function(name, symbol)()
        if per_sm <= 0:
            raise RuntimeError(f"{symbol}: occupancy query failed "
                               f"({per_sm})")
        n = per_sm * sm_count(device)
        _resident[key] = n
    return n


def _demangle(symbol: str) -> str:
    """``conv_wgmma_kernel<128>`` from an Itanium-mangled kernel symbol
    (nested names, integer and bool template arguments); a C name as it
    is."""
    m = re.match(r"_ZN?", symbol)
    if m is None:
        return symbol
    i, parts = m.end(), []
    while (d := re.match(r"\d+", symbol[i:])) is not None:
        n = int(d.group())
        i += d.end()
        parts.append(symbol[i:i + n])
        i += n
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", symbol[i:])
    out = parts[-1] if parts else symbol
    if args:
        vals = [v if t == "i" else ("true" if v == "1" else "false")
                for t, v in re.findall(r"L([ib])(-?\d+)E", args.group(1))]
        out += "<" + ", ".join(vals) + ">"
    return out


def parse_ptxas(report: str) -> List[Tuple[str, int, int, int, int]]:
    """``(kernel, registers, spill store bytes, spill load bytes, static
    shared memory bytes)`` for each entry function in a ``-Xptxas -v``
    report (dynamic shared memory is sized at launch, not here)."""
    out, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = _demangle(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1))) + spills +
                       (int(smem.group(1)) if smem else 0,))
            name = None
    return out


def resource_usage(name: str) -> List[Tuple[str, int, int, int, int]]:
    """:func:`parse_ptxas` of the build of ``csrc/<name>.cu`` (built
    first if it is not)."""
    return parse_ptxas(build(name).with_suffix(".ptxas.txt").read_text())


def check(err: int, what: str) -> None:
    """Raise when a launch returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
