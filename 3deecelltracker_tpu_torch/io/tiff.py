"""ctypes bindings for the port's TIFF codec (``csrc/tiff_codec.cc``, the
JAX package's ``native/tiff_codec.cc`` with a multi-page reader and
writer added).

The codec reads and writes the recording contract (single-page grayscale
TIFFs, 8/16-bit, uncompressed or LZW), decodes or encodes a whole z-stack
on a thread pool, reads and writes multi-page volumes (training data; it
reads them with several interleaved samples a pixel too, e.g. RGB),
and computes the exact 65536-bin histogram behind
``io.imageio.fast_percentiles``.  It is a host library: the card's machine
has no PIL, so nothing here falls back to one, and a failed build or a
failed call raises.

The library is compiled with ``g++`` at first use into the package's
``_build/`` (listed in ``.gitignore``), named by a digest of the source and
the flags.  Many processes may ask at once (test workers): an exclusive
``flock`` on ``_build/tiff_codec.lock`` spans the check and the compile,
the compiler writes a temporary file that ``os.replace`` moves into place,
and only that complete file is ever loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "tiff_codec.cc"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# a slice larger than 2^26 pixels is a corrupt header, not a microscope
MAX_SLICE_PIXELS = 1 << 26

_lib = None
_lock = threading.Lock()

_U16P = ctypes.POINTER(ctypes.c_uint16)
_PATHS = ctypes.POINTER(ctypes.c_char_p)
_INTP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "t3dct_tiff_info": [ctypes.c_char_p, _INTP, _INTP, _INTP],
    "t3dct_tiff_read": [ctypes.c_char_p, _U16P],
    "t3dct_tiff_read_volume": [_PATHS, ctypes.c_int, _U16P, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int],
    "t3dct_tiff_write_volume": [_PATHS, ctypes.c_int, _U16P, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int],
    "t3dct_tiff_pages": [ctypes.c_char_p, _INTP, _INTP, _INTP, _INTP,
                         _INTP],
    "t3dct_tiff_read_pages": [ctypes.c_char_p, _U16P, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "t3dct_tiff_write_pages": [ctypes.c_char_p, _U16P, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int],
    "t3dct_hist_u16": [_U16P, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_uint64)],
}


def find_cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the port's TIFF codec is compiled "
                           "from csrc/tiff_codec.cc at first use")
    return path


def library_path(build_dir: Path = None) -> Path:
    """Where the build of the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libtiff_codec_{digest}.so"


def build(build_dir: Path = None) -> Path:
    """Compile the codec unless this exact build exists; returns its path.
    Safe under concurrent processes (see the module docstring); raises
    when the compiler fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "tiff_codec.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():            # built while this one waited
                return out
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            try:
                res = subprocess.run(
                    [find_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE),
                     "-lpthread"], capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed for tiff_codec.cc:\n"
                                       f"{res.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load a build of the codec and set every signature."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The process's codec, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise OSError(f"{what}: TIFF codec error {rc}")


def _u16(a: np.ndarray):
    return a.ctypes.data_as(_U16P)


def _paths(paths: Sequence) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def tiff_info(path) -> Tuple[int, int, int]:
    """(width, height, bits) of a grayscale TIFF."""
    w, h, b = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(load().t3dct_tiff_info(str(path).encode(), ctypes.byref(w),
                                  ctypes.byref(h), ctypes.byref(b)),
           f"reading the header of {path}")
    if not (0 < w.value and 0 < h.value
            and w.value * h.value <= MAX_SLICE_PIXELS):
        raise OSError(f"{path}: implausible TIFF size {w.value}x{h.value}")
    return w.value, h.value, b.value


def tiff_read(path) -> np.ndarray:
    """One grayscale TIFF as (height, width) uint8 or uint16."""
    w, h, bits = tiff_info(path)
    out = np.empty((h, w), np.uint16)
    _check(load().t3dct_tiff_read(str(path).encode(), _u16(out)),
           f"decoding {path}")
    return out.astype(np.uint8) if bits == 8 else out


def tiff_read_volume(paths: List) -> np.ndarray:
    """A z-stack of same-shape slices, decoded in parallel (the codec's
    thread count, 0: one per core): (z, h, w)."""
    if not paths:
        raise ValueError("no slices to read")
    w, h, bits = tiff_info(paths[0])
    out = np.empty((len(paths), h, w), np.uint16)
    _check(load().t3dct_tiff_read_volume(_paths(paths), len(paths),
                                         _u16(out), w, h, 0),
           f"decoding the stack of {paths[0]}")
    return out.astype(np.uint8) if bits == 8 else out


def tiff_read_pages(path) -> np.ndarray:
    """Every page of a (multi-page) TIFF as (n_pages, h, w), or
    (n_pages, h, w, c) for pages of c > 1 interleaved samples a pixel
    (``PlanarConfiguration`` 1, e.g. RGB), as PIL reads them; the pages
    must share their size, bit depth and samples."""
    n, w, h, b, c = (ctypes.c_int() for _ in range(5))
    _check(load().t3dct_tiff_pages(str(path).encode(), ctypes.byref(n),
                                   ctypes.byref(w), ctypes.byref(h),
                                   ctypes.byref(b), ctypes.byref(c)),
           f"reading the pages of {path}")
    if not (0 < w.value and 0 < h.value and
            n.value * w.value * h.value * c.value
            <= MAX_SLICE_PIXELS * 64):
        raise OSError(f"{path}: implausible TIFF size {n.value}x"
                      f"{w.value}x{h.value}x{c.value}")
    shape = (n.value, h.value, w.value) + ((c.value,) if c.value > 1
                                           else ())
    out = np.empty(shape, np.uint16)
    _check(load().t3dct_tiff_read_pages(str(path).encode(), _u16(out),
                                        n.value, w.value, h.value, c.value),
           f"decoding {path}")
    return out.astype(np.uint8) if b.value == 8 else out


def _bits(a: np.ndarray) -> int:
    if a.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"TIFF slices are uint8 or uint16, not {a.dtype}")
    return 8 if a.dtype == np.uint8 else 16


def tiff_write_volume(paths: List, vol: np.ndarray, lzw: bool = True
                      ) -> None:
    """Write a (z, h, w) uint8/uint16 stack as one TIFF per slice, encoded
    in parallel with the GIL released."""
    if vol.ndim != 3 or len(paths) != vol.shape[0]:
        raise ValueError(f"{len(paths)} paths for a stack of {vol.shape}")
    bits = _bits(vol)
    buf = np.ascontiguousarray(vol, np.uint16)
    _check(load().t3dct_tiff_write_volume(
        _paths(paths), len(paths), _u16(buf), vol.shape[2], vol.shape[1],
        bits, 5 if lzw else 1, 0), f"writing the stack {paths[0]}")


def tiff_write_pages(path, vol: np.ndarray, lzw: bool = False) -> None:
    """Write a (n, h, w) uint8/uint16 stack as one multi-page TIFF (the
    pages :func:`tiff_read_pages` reads)."""
    if vol.ndim != 3 or vol.shape[0] < 1:
        raise ValueError(f"a multi-page TIFF takes (n, h, w), got "
                         f"{vol.shape}")
    bits = _bits(vol)
    buf = np.ascontiguousarray(vol, np.uint16)
    _check(load().t3dct_tiff_write_pages(
        str(path).encode(), _u16(buf), vol.shape[0], vol.shape[2],
        vol.shape[1], bits, 5 if lzw else 1), f"writing {path}")


def hist_u16(x: np.ndarray) -> np.ndarray:
    """Exact 65536-bin histogram (uint64) of a uint16 array."""
    if x.dtype != np.uint16:
        raise TypeError(f"hist_u16 takes uint16, not {x.dtype}")
    flat = np.ascontiguousarray(x).ravel()
    counts = np.empty(65536, np.uint64)
    _check(load().t3dct_hist_u16(
        _u16(flat), ctypes.c_longlong(flat.size),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))),
        "histogram")
    return counts
