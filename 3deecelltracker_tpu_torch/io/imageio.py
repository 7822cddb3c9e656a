"""TIFF and HDF5 recordings in, label TIFFs out (counterpart of
``3deecelltracker_tpu/io/imageio.py``: ``imread`` :31, ``imread_volume`` :44,
``imwrite_volume`` :63, ``save_recording_h5`` :78, ``imread_stack`` :98,
``fast_percentiles`` :119, ``transport_encode`` :204,
``percentile_normalize`` :227, ``load_image`` :246,
``load_2d_slices_at_time`` :255,
``get_t_range`` :285, ``read_image_ts`` :302, ``save_label_slices`` :310,
``save_volume_slices`` :334).

Only what the v1.0 workflow and its trainers use, and no PIL: every TIFF
read and write goes through the port's codec (``io.tiff``), which raises
where the JAX package would fall back to PIL.  The data contract is the
JAX package's: per-(t, z) single-page grayscale TIFFs found by a
``"...t%03i_z*.tif"`` glob, or an HDF5 recording ``{"h5_file": path,
"channel": c[, "dset": "default"]}`` holding one (T, C, Z, Y, X) dataset
(``stardistwrapper.py:62-70``); label volumes are written per z in the
(x, y, z) frame.  ``h5py`` is imported only by the functions that read or
write HDF5, so the package imports without it; there they raise its
``ImportError``.
"""

from __future__ import annotations

import os
import re
from glob import glob
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from . import tiff

_TIFF = (".tif", ".tiff")
_HDF5 = (".h5", ".hdf5")

PathPattern = Union[str, Dict]


def check_recording(images_path: PathPattern) -> None:
    """Raise unless ``images_path`` is a recording the port reads: a TIFF
    path pattern (a str), or an HDF5 recording (a dict naming an ``.h5`` /
    ``.hdf5`` file, JAX's ``AssertionError`` otherwise; where ``h5py`` does
    not import, its ``ImportError``, before the entry points write
    anything).  Anything else raises JAX's ``ValueError``."""
    if isinstance(images_path, str):
        return
    if isinstance(images_path, dict):
        if os.path.splitext(images_path["h5_file"])[1] not in _HDF5:
            raise AssertionError(
                "Only TIFF sequences or HDF5 datasets are supported")
        import_h5py()
        return
    raise ValueError("images_path should be a str (TIFF) or dict (HDF5)")


def import_h5py():
    """``h5py``, imported where HDF5 is read or written; without it the
    ``ImportError`` names the package."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "HDF5 recordings and Keras .h5 checkpoints need h5py, which "
            "does not import here") from e
    return h5py


def save_recording_h5(h5_file: str, volumes, dset: str = "default",
                      n_channels: int = 1) -> None:
    """Write a recording as the (T, C, Z, Y, X) HDF5 dataset that
    :func:`load_2d_slices_at_time` and :func:`get_t_range` read, gzip level
    1 in chunks of one volume (JAX ``save_recording_h5``; the reference
    only reads this layout).  ``volumes``: an array or sequence of (z, y,
    x) volumes, or (T, C, Z, Y, X) directly; ``n_channels`` is accepted
    for JAX's signature, the channels come from the array."""
    h5py = import_h5py()
    arr = np.asarray(volumes)
    if arr.ndim == 4:                     # (T, Z, Y, X): one channel
        arr = arr[:, None]
    if arr.ndim != 5:
        raise ValueError(f"expected (T,[C,]Z,Y,X), got shape {arr.shape}")
    with h5py.File(str(h5_file), "w") as f:
        f.create_dataset(dset, data=arr, chunks=(1, 1) + arr.shape[2:],
                         compression="gzip", compression_opts=1)


def _require_tiff(path) -> None:
    if not str(path).lower().endswith(_TIFF):
        raise NotImplementedError(f"{path}: the port reads TIFF only")


def imread(path) -> np.ndarray:
    """One grayscale TIFF slice."""
    _require_tiff(path)
    return tiff.tiff_read(path)


def imread_volume(path) -> np.ndarray:
    """A (multi-page) TIFF as a volume: (n_pages, h, w), or the 2-D slice
    of a single-page file (the ``tifffile.imread`` role for the training
    volumes, ``stardistwrapper.py:173-175``).  Every page is read: a
    reader of page 0 alone would train on one z-slice of each volume."""
    _require_tiff(path)
    vol = tiff.tiff_read_pages(path)
    return vol[0] if vol.shape[0] == 1 else vol


def imwrite_volume(path: str, vol: np.ndarray,
                   compression: str = None) -> None:
    """Write a (z, h, w) uint8 or uint16 volume (or one 2-D slice) as one
    multi-page TIFF that :func:`imread_volume` reads (the tifffile
    ``imwrite`` role, e.g. for StarDist training volumes).
    ``compression``: None or ``"tiff_lzw"``."""
    if compression not in (None, "tiff_lzw"):
        raise ValueError(f"compression must be None or 'tiff_lzw', got "
                         f"{compression!r}")
    _require_tiff(path)
    vol = np.asarray(vol)
    tiff.tiff_write_pages(path, vol[None] if vol.ndim == 2 else vol,
                          lzw=compression == "tiff_lzw")


def imread_stack(paths: List) -> np.ndarray:
    """Same-shape TIFF slices stacked into (z, h, w), decoded in
    parallel."""
    if paths:
        _require_tiff(paths[0])
    return tiff.tiff_read_volume(list(paths))


def fast_percentiles(x: np.ndarray, qs) -> np.ndarray:
    """``np.percentile(x, qs)`` bit for bit (linear interpolation) for
    small-range non-negative integers, from an exact counting sort: the
    k-th smallest value comes out of the cumulative histogram, and the
    lerp is numpy's, including its switch to the upper side at t >= 0.5.
    uint16 counts in the codec (one pass, GIL released); other integer
    arrays below 2^20 by ``np.bincount``; everything else by
    ``np.percentile`` itself."""
    qs_arr = np.atleast_1d(np.asarray(qs, np.float64))
    if np.any((qs_arr < 0.0) | (qs_arr > 100.0)):
        raise ValueError("Percentiles must be in the range [0, 100]")
    if x.dtype == np.bool_:
        x = x.view(np.uint8)
    if not np.issubdtype(x.dtype, np.integer) or x.size == 0:
        return np.percentile(x, qs_arr)
    flat = x.ravel()
    if flat.dtype not in (np.uint8, np.uint16):
        lo, hi = flat.min(), flat.max()
        if lo < 0 or hi >= (1 << 20):
            return np.percentile(x, qs_arr)
    counts = (tiff.hist_u16(flat) if flat.dtype == np.uint16
              else np.bincount(flat))
    csum = np.cumsum(counts)
    n = int(flat.size)
    out = np.empty(qs_arr.shape, np.float64)
    for i, q in enumerate(qs_arr):
        pos = q / 100.0 * (n - 1)
        k = int(np.floor(pos))
        d = pos - k
        vk = float(np.searchsorted(csum, k + 1, side="left"))
        if d > 0.0:
            vk1 = float(np.searchsorted(csum, min(k + 2, n), side="left"))
            diff = vk1 - vk
            vk = vk1 - diff * (1.0 - d) if d >= 0.5 else vk + diff * d
        out[i] = vk
    return out


def check_transport(transport: str) -> None:
    """Raise unless ``transport`` is a wire format the port has."""
    if transport == "u8":
        raise NotImplementedError(
            "transport='u8' is not ported yet (ROADMAP.md A.5b); use "
            "transport='u16'")
    if transport != "u16":
        raise ValueError(f"transport must be 'u16' or 'u8', got "
                         f"{transport!r}")


def transport_encode(x: np.ndarray, transport: str
                     ) -> Tuple[np.ndarray, float, float]:
    """The raw volume's wire format to the card: ``(x, mi, ma)``, where
    the device normalizes ``x`` with ``norm_minmax=(mi, ma)``, the volume's
    exact 1/99.8 percentiles.  ``"u16"`` only: the raw volume travels
    lossless."""
    check_transport(transport)
    mi, ma = fast_percentiles(x, (1.0, 99.8))
    return x, float(mi), float(ma)


def percentile_normalize(x: np.ndarray, pmin: float = 1.0,
                         pmax: float = 99.8, eps: float = 1e-20
                         ) -> np.ndarray:
    """csbdeep's ``normalize`` over the whole array, in float32 (integer
    input takes its percentiles from :func:`fast_percentiles`)."""
    if np.issubdtype(x.dtype, np.integer):
        mi, ma = np.float32(fast_percentiles(x, (pmin, pmax)))
        return (x.astype(np.float32, copy=False) - mi) / (ma - mi + eps)
    x = x.astype(np.float32, copy=False)
    mi, ma = np.percentile(x, pmin), np.percentile(x, pmax)
    return (x - mi) / (ma - mi + eps)


def load_image(folder_path: str) -> np.ndarray:
    """A volume from a folder of 2-D TIFF slices, every file in sorted
    name order one z, in the (x, y, z) frame (``preprocess.py:59-82``; the
    proofed ``manual_vol1/`` labels, a U-Net training folder)."""
    files = sorted(os.path.join(folder_path, f)
                   for f in os.listdir(folder_path))
    return imread_stack(files).transpose(1, 2, 0)


def load_2d_slices_at_time(images_path: PathPattern, t: int,
                           do_normalize: bool = True) -> np.ndarray:
    """Every 2-D slice of volume ``t`` as a (z, y, x) stack: of a TIFF
    pattern the files ``sorted(glob(images_path % t))``, which raises
    ``FileNotFoundError`` when there is none (the end of a recording); of
    an HDF5 recording ``f[dset][t - 1, channel]``."""
    check_recording(images_path)
    if isinstance(images_path, dict):
        with import_h5py().File(images_path["h5_file"], "r") as f:
            dset = f[images_path.get("dset", "default")]
            x = dset[t - 1, images_path["channel"], :, :, :]
        return percentile_normalize(x) if do_normalize else x
    if os.path.splitext(images_path)[1] not in _TIFF:
        raise AssertionError(
            "Only TIFF sequences or HDF5 datasets are supported")
    paths = sorted(glob(images_path % t))
    if not paths:
        raise FileNotFoundError(f"No image at time {t} was found")
    x = imread_stack(paths)
    return percentile_normalize(x) if do_normalize else x


def get_t_range(images_path: PathPattern) -> Tuple[int, int]:
    """(largest, smallest) time index: of the files near a TIFF pattern,
    or ``(T, 1)`` of an HDF5 recording of T volumes."""
    check_recording(images_path)
    if isinstance(images_path, dict):
        with import_h5py().File(images_path["h5_file"], "r") as f:
            return f[images_path.get("dset", "default")].shape[0], 1
    p = Path(images_path)
    filenames = glob(str(p.parent / ("*t*" + p.suffix)))
    if not filenames:
        raise FileNotFoundError(f"No image files found near {p}")
    numbers = [int(re.findall(r"t(\d+)", Path(f).name)[0])
               for f in filenames]
    return max(numbers), min(numbers)


def read_image_ts(vol: int, path_pattern: str, z_range: Tuple[int, int]
                  ) -> np.ndarray:
    """The slices ``path_pattern % (vol, z)`` for z in ``range(*z_range)``
    as an (x, y, z) volume (the legacy per-(t, z) loader,
    ``tracker.py:113-133``)."""
    return np.stack([imread(path_pattern % (vol, z))
                     for z in range(z_range[0], z_range[1])], axis=2)


def save_label_slices(labels_xyz: np.ndarray, out_dir: Union[str, Path],
                      name_pattern: str, t: int, use_8_bit: bool = True,
                      compression: str = "tiff_lzw") -> None:
    """Write an (x, y, z) label volume as one TIFF per z, named
    ``name_pattern % (t, z)`` for z = 1.., uint8 or uint16, LZW (the
    default) or uncompressed (``compression=None``)."""
    if compression not in (None, "tiff_lzw"):
        raise NotImplementedError(f"compression {compression!r}: the port "
                                  f"writes None or 'tiff_lzw'")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(labels_xyz).astype(np.uint8 if use_8_bit
                                        else np.uint16)
    paths = [out / (name_pattern % (t, z))
             for z in range(1, arr.shape[2] + 1)]
    tiff.tiff_write_volume(paths, np.ascontiguousarray(
        arr.transpose(2, 0, 1)), lzw=compression == "tiff_lzw")


def save_volume_slices(labels_xyz: np.ndarray, out_dir: Union[str, Path],
                       name_pattern: str) -> None:
    """Write an (x, y, z) volume as uncompressed per-z TIFFs named
    ``name_pattern % z`` (``auto_vol1_z%04i.tif``), uint8 when every value
    fits, else uint16."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(labels_xyz)
    arr = arr.astype(np.uint8 if arr.max() <= 255 else np.uint16)
    paths = [out / (name_pattern % z) for z in range(1, arr.shape[2] + 1)]
    tiff.tiff_write_volume(paths, np.ascontiguousarray(
        arr.transpose(2, 0, 1)), lzw=False)
