"""Figures: the merged-label PNGs, the matching figures, the StarDist
training previews, the activity grid and the legacy workflow's inspection
plots (counterpart of ``3deecelltracker_tpu/viz.py``).

The merged-label PNGs (:func:`save_merged_labels`) are written without PIL
or matplotlib, which the card's machine lacks.  Their pixels are the JAX
package's: the same random label colours, the raw volume's max projection
scaled to 8 bits, and PIL's 50% blend, which is ``(a + b) >> 1`` per byte.
The files are plain RGB PNGs (no row filter, zlib level 1), so their bytes
differ from PIL's while the decoded images agree.

Every other figure is drawn with matplotlib, as in the JAX package, with
its figure sizes, colours, titles and dpi.  matplotlib is imported only
inside the functions that draw (:func:`pyplot`), so this module and every
module that draws import without it; a figure asked for without it raises
an ``ImportError`` that names matplotlib.  ``lbl_cmap`` (JAX builds it at
import) is built at its first use.
"""

from __future__ import annotations

import functools
import os
import struct
import sys
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from .io.artifacts import (MERGED_LABELS, MERGED_LABELS_XZ, TRACK_RESULTS,
                           ResultsTree)
from .io.imageio import load_2d_slices_at_time


def pyplot():
    """``matplotlib.pyplot``, imported at the first figure.  As in the JAX
    package (``viz.py:18-26``), Agg is chosen only on a headless host
    where nothing has chosen a backend yet, so an interactive session's
    backend is kept."""
    import matplotlib
    if (os.environ.get("MPLBACKEND") is None
            and os.environ.get("DISPLAY") is None
            and sys.platform != "darwin"
            and "matplotlib.pyplot" not in sys.modules):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def random_label_colors(n: int = 2 ** 16, seed: int = 42) -> np.ndarray:
    """(n, 3) float RGB in [0, 1]: random hues, saturation in [0.4, 1],
    value in [0.6, 1], colour 0 black (matplotlib's ``hsv_to_rgb`` of the
    JAX package's draws)."""
    rng = np.random.RandomState(seed)
    h = rng.uniform(0, 1, n)
    s = rng.uniform(0.4, 1.0, n)
    v = rng.uniform(0.6, 1.0, n)
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = i % 6
    rgb = np.empty((n, 3))
    for k, (r, g, b) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                   (p, q, v), (t, p, v), (v, p, q))):
        sel = sector == k
        rgb[sel] = np.stack([r[sel], g[sel], b[sel]], axis=1)
    rgb[0] = 0
    return rgb


LABEL_COLORS = random_label_colors()


def random_label_cmap(n: int = 2 ** 16, seed: int = 42):
    """The random label colours as a ``ListedColormap`` (stardist's
    ``random_label_cmap``, JAX ``viz.py:32``)."""
    from matplotlib.colors import ListedColormap
    cols = random_label_colors(n, seed)
    cmap = ListedColormap(cols)
    cmap.colors = cols
    return cmap


@functools.lru_cache(maxsize=1)
def _label_cmap():
    return random_label_cmap()


def __getattr__(name):
    # JAX builds lbl_cmap at import (viz.py:47); here at its first use
    if name == "lbl_cmap":
        return _label_cmap()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---- merged-label PNGs, without PIL ----------------------------------------

def write_png(path, rgb: np.ndarray) -> None:
    """An (h, w, 3) uint8 image as an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)],
                          axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                 + chunk(b"IEND", b""))


def _label_rgb(lab2d: np.ndarray) -> np.ndarray:
    colors = LABEL_COLORS[lab2d % len(LABEL_COLORS)]
    return (colors * 255).astype(np.uint8)


def _gray_rgb(img: np.ndarray) -> np.ndarray:
    gray = (img * 255 / img.max()).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=2)


def _blend(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ((a.astype(np.uint16) + b) >> 1).astype(np.uint8)


def save_merged_labels(tree, corrected_labels_image, images_path,
                       t: int, interpolation_factor: int) -> None:
    """The labels of volume ``t`` over its raw volume, as x-y and x-z max
    projections (z stretched by ``interpolation_factor``), into the
    results tree ``tree`` (an ``io.artifacts.ResultsTree`` or its root
    directory):
    ``track_results/merged_labels{,_xz}/merged_labels{,_xz}_t%06d.png``."""
    root = tree.root if isinstance(tree, ResultsTree) else Path(tree)
    lab = np.asarray(corrected_labels_image).astype(np.int64)
    raw = load_2d_slices_at_time(images_path, t=t)
    merged = _blend(_label_rgb(lab.max(axis=2)), _gray_rgb(raw.max(axis=0)))
    lab_xz = np.repeat(_label_rgb(lab.max(axis=0)).transpose(1, 0, 2),
                       interpolation_factor, axis=0)
    raw_xz = np.repeat(raw.max(axis=1), interpolation_factor, axis=0)
    merged_xz = _blend(lab_xz, _gray_rgb(raw_xz))
    d1 = root / TRACK_RESULTS / MERGED_LABELS
    d2 = root / TRACK_RESULTS / MERGED_LABELS_XZ
    d1.mkdir(parents=True, exist_ok=True)
    d2.mkdir(parents=True, exist_ok=True)
    write_png(d1 / ("merged_labels_t%06d.png" % t), merged)
    write_png(d2 / ("merged_labels_xz_t%06d.png" % t), merged_xz)


# ---- StarDist training previews (stardistwrapper.py:289-329) ---------------

def _finish(fig, plt, path, **savefig):
    """Lay the figure out as JAX does and, given a path, save and close
    it."""
    plt.tight_layout()
    if path:
        fig.savefig(path, **savefig)
        plt.close(fig)
    return fig


def plot_img_label_center_slice(img, lbl, img_title="image (XY slice)",
                                lbl_title="label (XY slice)", z=None,
                                path: Optional[str] = None):
    """The image and its labels at z-slice ``z`` (the centre by default),
    side by side (``stardistwrapper.plot_img_label_center_slice``)."""
    plt = pyplot()
    img, lbl = np.asarray(img), np.asarray(lbl)
    if z is None:
        z = img.shape[0] // 2
    fig, (ai, al) = plt.subplots(
        1, 2, figsize=(15, 7), gridspec_kw=dict(width_ratios=(1.25, 1)))
    im = ai.imshow(img[z], cmap="gray", clim=(0, 1))
    ai.set_title(img_title)
    fig.colorbar(im, ax=ai)
    al.imshow(lbl[z], cmap=_label_cmap())
    al.set_title(lbl_title)
    return _finish(fig, plt, path)


def plot_img_label_max_projection(img, lbl,
                                  img_title="image (max projection/x-y)",
                                  lbl_title="label (max projection)",
                                  fig_width_px=1200, dpi=96,
                                  path: Optional[str] = None):
    """The x-y max projections of the image and its labels."""
    plt = pyplot()
    img, lbl = np.asarray(img), np.asarray(lbl)
    w = fig_width_px / dpi
    fig, (ai, al) = plt.subplots(1, 2, figsize=(w, w / 1.618))
    ai.imshow(img.max(axis=0), clim=(0, 1), vmin=0, vmax=1)
    ai.set_title(img_title)
    al.imshow(lbl.max(axis=0), cmap=_label_cmap())
    al.set_title(lbl_title)
    return _finish(fig, plt, path)


def plot_img_label_max_projection_xz(img, lbl,
                                     img_title="image (max projection/x-z)",
                                     lbl_title="label (max projection)",
                                     fig_width_px=1200, dpi=96,
                                     scale_z: int = 1,
                                     path: Optional[str] = None):
    """The x-z max projections, z stretched by ``scale_z``."""
    plt = pyplot()
    img, lbl = np.asarray(img), np.asarray(lbl)
    w = fig_width_px / dpi
    fig, (ai, al) = plt.subplots(1, 2, figsize=(w, w / 1.618))
    ai.imshow(img.max(axis=1), clim=(0, 1), vmin=0, vmax=1, aspect=scale_z)
    ai.set_title(img_title)
    al.imshow(lbl.max(axis=1), cmap=_label_cmap(), aspect=scale_z)
    al.set_title(lbl_title)
    return _finish(fig, plt, path)


# ---- matching figures (coord_image_transformer.py:650-757,
# trackerlite.py:204-239) -----------------------------------------------------

def plot_two_pointset_scatters(ref_ptrs, tgt_ptrs, t1, t2,
                               fig_width_px=1200, dpi=96):
    """Two point sets (real units, (x, y, z) rows) as scatters on two axes
    with shared limits, stacked when the sets are wider than tall.
    Returns (ax1, ax2, fig)."""
    plt = pyplot()
    w_in = fig_width_px / dpi
    h_in = w_in / 1.618
    ry, rx = (np.ptp(ref_ptrs[:, 0]), np.ptp(ref_ptrs[:, 1]))
    ty, tx = (np.ptp(tgt_ptrs[:, 0]), np.ptp(tgt_ptrs[:, 1]))
    top_down = rx + tx >= ry + ty
    if top_down:
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(w_in, h_in))
    else:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(w_in, h_in))
    ax1.scatter(ref_ptrs[:, 1], -ref_ptrs[:, 0], facecolors="b",
                edgecolors="b")
    ax2.scatter(tgt_ptrs[:, 1], -tgt_ptrs[:, 0], facecolors="b",
                edgecolors="b")
    unify_xy_lims(ax1, ax2)
    if top_down:
        ax1.set_ylabel(f"Point Set t={t1}")
        ax2.set_ylabel(f"Point Set t={t2}")
    else:
        ax1.set_title(f"Point Set t={t1}")
        ax2.set_title(f"Point Set t={t2}")
    return ax1, ax2, fig


def _connect(ax1, ax2, src, dst):
    """A line from ``dst`` on ``ax2`` to ``src`` on ``ax1``."""
    from matplotlib.patches import ConnectionPatch
    ax2.add_artist(ConnectionPatch(
        xyA=(dst[1], -dst[0]), xyB=(src[1], -src[0]), coordsA="data",
        coordsB="data", axesA=ax2, axesB=ax1, color="C1"))


def plot_prgls_prediction(ref_ptrs, tgt_ptrs, predicted_ref_ptrs, t1, t2,
                          fig_width_px=1200, dpi=96):
    """The reference set at ``t1``, the segmented set at ``t2``, and a line
    from each reference cell to its predicted position."""
    ax1, ax2, fig = plot_two_pointset_scatters(ref_ptrs, tgt_ptrs, t1, t2,
                                               fig_width_px, dpi)
    for ref_ptr, tgt_ptr in zip(ref_ptrs, predicted_ref_ptrs):
        _connect(ax1, ax2, ref_ptr, tgt_ptr)
    return fig


def plot_initial_matching(ref_ptrs, tgt_ptrs, pairs_px2, t1, t2,
                          fig_width_px=1200, dpi=96):
    """The FFN's initial matching: a line for each (ref, tgt) row pair."""
    ax1, ax2, fig = plot_two_pointset_scatters(ref_ptrs, tgt_ptrs, t1, t2,
                                               fig_width_px, dpi)
    for ref_index, tgt_index in pairs_px2:
        _connect(ax1, ax2, ref_ptrs[ref_index], tgt_ptrs[tgt_index])
    return fig


def save_matching_figure(tree, confirmed_t1_real, seg_t2_real, coords_real,
                         t1: int, t2: int) -> None:
    """Volume ``t2``'s matching figure in the results tree,
    ``track_results/figure/matching_<t2>.png``
    (``coord_image_transformer.py:516-522``)."""
    plt = pyplot()
    fig = plot_prgls_prediction(confirmed_t1_real, seg_t2_real, coords_real,
                                t1, t2)
    tree.figure_dir.mkdir(parents=True, exist_ok=True)
    fig.savefig(tree.figure_dir / f"matching_{t2:06d}.png",
                facecolor="white")
    plt.close(fig)


# ---- activities (analyses.py:113-187) -------------------------------------

def optimize_row_column(duration, n_signals, figsize):
    """Rows and columns of the activity grid for the figure's aspect; at
    least one row (the reference divides by zero for short recordings)."""
    whr = figsize[0] / figsize[1]
    total = duration * n_signals
    row_n = max(int((total / (50 * whr)) ** 0.5), 1)
    col_n = int(np.ceil(n_signals / row_n))
    return row_n, col_n


def draw_signals(signals, ylim_upper=None, ylim_lower=None,
                 figsize=(20, 10)):
    """One panel per cell of a (volumes, cells) activity array.  Returns
    (fig, axes)."""
    plt = pyplot()
    row_n, col_n = optimize_row_column(signals.shape[0], signals.shape[1],
                                       figsize)
    fig, axes = plt.subplots(row_n, col_n, figsize=figsize, squeeze=False)
    for row in range(row_n):
        for col in range(col_n):
            n = row * col_n + col
            if n >= signals.shape[1]:
                break
            ax = axes[row, col]
            ax.plot(signals[:, n], lw=2)
            up = ylim_upper if ylim_upper is not None else \
                np.nanmax(signals[:, n])
            lo = ylim_lower if ylim_lower is not None else \
                np.nanmin(signals[:, n])
            ax.set_ylim(lo, up)
            ax.set_title("N%d" % (n + 1), va="top")
            if row < row_n - 1:
                ax.get_xaxis().set_visible(False)
    plt.subplots_adjust(left=0.02, bottom=0.02, right=0.98, top=0.98,
                        wspace=0.2, hspace=0.2)
    return fig, axes


# ---- segmentation and tracking figures (tracker.py:212-461) ----------------

def _label_image(lab2d):
    """Label ids as indices into the label colours."""
    return lab2d % len(_label_cmap().colors)


def draw_segresult(image3d, segmentation3d, percentile_top=99.9,
                   percentile_bottom=10):
    """The raw volume and its segmentation, one animation frame per z
    (an ``ArtistAnimation``)."""
    plt = pyplot()
    from matplotlib import animation
    img = np.asarray(image3d)
    seg = np.asarray(segmentation3d).astype(np.int64)
    vmax = np.percentile(img, percentile_top)
    vmin = np.percentile(img, percentile_bottom)
    fig, (a, b) = plt.subplots(1, 2, figsize=(14, 7))
    a.set_title("raw image")
    b.set_title("segmentation")
    frames = []
    for z in range(img.shape[2]):
        f1 = a.imshow(img[:, :, z], cmap="gray", vmin=vmin, vmax=vmax,
                      animated=True)
        f2 = b.imshow(_label_image(seg[:, :, z]), cmap=_label_cmap(),
                      interpolation="none", animated=True)
        frames.append([f1, f2])
    return animation.ArtistAnimation(fig, frames, interval=200)


def draw_manual_seg1(manual_segmentation3d):
    """The max projection of the proofed vol-1 labels."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(_label_image(np.max(np.asarray(manual_segmentation3d)
                                  .astype(np.int64), axis=2)),
              cmap=_label_cmap(), interpolation="none")
    ax.set_title("Manual segmentation at vol 1 (max projection)")
    return fig


def _arrow(ax, src, dst, x, y, sign=-1):
    """An arrow from ``src`` to ``dst`` with axis ``x`` across and
    ``sign`` times axis ``y`` up."""
    return ax.annotate("", xy=(dst[x], sign * dst[y]),
                       xytext=(src[x], sign * src[y]),
                       arrowprops=dict(arrowstyle="->", color="C1", lw=0.8))


def ffn_prgls_animation(rep_frames, seg_coords):
    """The FFN + PR-GLS prediction rep by rep as an ``ArtistAnimation``:
    the segmented cells and an arrow from each cell's position before the
    rep to its position after.  ``rep_frames``: (pre, post) coordinate
    pairs, one per rep."""
    plt = pyplot()
    from matplotlib import animation
    fig, ax = plt.subplots(figsize=(10, 10))
    artists = []
    for pre, post in rep_frames:
        objs = [ax.scatter(seg_coords[:, 1], -seg_coords[:, 0], c="C0",
                           s=12, animated=True)]
        objs += [_arrow(ax, s, d, 1, 0) for s, d in zip(pre, post)]
        artists.append(objs)
    return animation.ArtistAnimation(fig, artists, interval=200)


def ffn_prgls_grid(member_frames, seg_coords, member_labels=None,
                   path: Optional[str] = None):
    """The frames of :func:`ffn_prgls_animation` as a grid: one row per
    ensemble member (reference volume), one column per rep.
    ``member_frames``: per member, its (pre, post) pairs per rep."""
    plt = pyplot()
    seg = np.asarray(seg_coords)
    n_mem = len(member_frames)
    n_rep = max(len(f) for f in member_frames)
    fig, axs = plt.subplots(n_mem, n_rep,
                            figsize=(3.2 * n_rep, 3.2 * n_mem),
                            squeeze=False)
    for mi, frames in enumerate(member_frames):
        for ri in range(n_rep):
            ax = axs[mi, ri]
            if ri >= len(frames):
                ax.axis("off")
                continue
            pre, post = frames[ri]
            plot_transformation_arrows(ax, np.asarray(pre), seg,
                                       np.asarray(post))
            ax.set_xticks([])
            ax.set_yticks([])
            if mi == 0:
                ax.set_title(f"rep {ri + 1}", fontsize=9)
            if ri == 0 and member_labels:
                ax.set_ylabel(member_labels[mi], fontsize=9)
    return _finish(fig, plt, path, bbox_inches="tight", facecolor="white")


def plot_transformation_arrows(ax, ref_ptrs, tgt_ptrs, predicted_ref_ptrs,
                               layercoord=False):
    """The segmented targets as dots and an arrow from each reference
    position to its predicted one, on ``ax`` (track.py:412-471)."""
    ax.scatter(tgt_ptrs[:, 1], -tgt_ptrs[:, 0], c="C0", s=12,
               label="segmented (target)")
    for src, dst in zip(ref_ptrs, predicted_ref_ptrs):
        _arrow(ax, src, dst, 1, 0)
    ax.set_aspect("equal")
    return ax


def draw_matching_6panel(raw_img3d, tracked_labels, r_coor_predicted,
                         r_coor_segmented, r_tracked_prev, z_xy_ratio=1.0,
                         path: Optional[str] = None):
    """A tracked volume's six panels (tracker.py:342-358): the raw x-y and
    x-z projections, the tracked labels, the prediction's arrows, and the
    segmented against the tracked cells."""
    plt = pyplot()
    fig, axs = plt.subplots(3, 2, figsize=(14, 14))
    raw = np.asarray(raw_img3d)
    lab = np.asarray(tracked_labels).astype(np.int64)
    stretch = max(1, int(z_xy_ratio))
    axs[0, 0].imshow(raw.max(axis=2), cmap="gray")
    axs[0, 0].set_title("raw (x-y projection)")
    axs[0, 1].imshow(np.repeat(raw.max(axis=0).T, stretch, axis=0),
                     cmap="gray")
    axs[0, 1].set_title("raw (x-z projection)")
    axs[1, 0].imshow(_label_image(lab.max(axis=2)), cmap=_label_cmap(),
                     interpolation="none")
    axs[1, 0].set_title("tracked labels (x-y)")
    axs[1, 1].imshow(np.repeat((lab.max(axis=0) > 0).T.astype(float),
                               stretch, axis=0), cmap="gray")
    axs[1, 1].set_title("tracked labels (x-z)")
    seg = np.asarray(r_coor_segmented)
    pred = np.asarray(r_coor_predicted)
    plot_transformation_arrows(axs[2, 0], np.asarray(r_tracked_prev), seg,
                               pred)
    axs[2, 0].set_title("FFN + PR-GLS prediction")
    axs[2, 1].scatter(seg[:, 1], -seg[:, 0], c="C0", s=10,
                      label="segmented")
    axs[2, 1].scatter(pred[:, 1], -pred[:, 0], c="C1", s=10, marker="x",
                      label="tracked")
    axs[2, 1].legend()
    axs[2, 1].set_title("segmented vs tracked")
    return _finish(fig, plt, path, bbox_inches="tight", facecolor="white")


def draw_correction(image_cell_bg_xyz, pred_layer, seg_layer,
                    corrected_layer, z_xy_ratio: float = 1.0,
                    path: Optional[str] = None):
    """The accurate correction (tracker.py:281-314), in the y-x and y-z
    planes: the thresholded cell regions in gray, the segmented centres
    as dots, and an arrow from each predicted position to its corrected
    one.  Coordinates in layer units (z divided by ``z_xy_ratio``)."""
    plt = pyplot()
    bg = np.asarray(image_cell_bg_xyz)
    if bg.ndim == 5:                     # the reference's (1, x, y, z, 1)
        bg = bg[0, ..., 0]
    pred = np.asarray(pred_layer)
    seg = np.asarray(seg_layer)
    corr = np.asarray(corrected_layer)
    fig, (a, b) = plt.subplots(1, 2, figsize=(14, 7))
    a.set_title("Accurate Correction (y-x plane)", size=16)
    b.set_title("Accurate Correction (y-z plane)", size=16)
    a.imshow(bg.max(axis=2) > 0.5, cmap="gray")
    b.imshow((bg.max(axis=0) > 0.5).T, cmap="gray",
             aspect=max(z_xy_ratio, 1e-6))
    a.scatter(seg[:, 1], seg[:, 0], c="C0", s=12, label="segmented")
    b.scatter(seg[:, 1], seg[:, 2], c="C0", s=12, label="segmented")
    for src, dst in zip(pred, corr):
        _arrow(a, src, dst, 1, 0, sign=1)
        _arrow(b, src, dst, 1, 2, sign=1)
    a.legend()
    if path:
        fig.savefig(path, facecolor="white")
        plt.close(fig)
    return fig


def draw_overlapping(regions_img3d, labels_before, labels_after,
                     z_xy_ratio: float = 1.0, path: Optional[str] = None,
                     volume2: Optional[int] = None,
                     vol_labels: int = 1):
    """The labels before and after matching over the volume's cell
    regions (tracker.py:316-390), x-y and x-z; ``volume2`` and
    ``vol_labels`` name the volumes in the titles."""
    plt = pyplot()
    cmap = _label_cmap()
    raw = np.asarray(regions_img3d)
    stretch = max(1, int(z_xy_ratio))
    fig, axs = plt.subplots(2, 2, figsize=(14, 14))
    at = "" if volume2 is None else f": cells at vol {volume2}"
    for ax, lab, title in (
            (axs[0], labels_before,
             f"Before matching{at}"
             + ("" if volume2 is None else f" + labels at vol {vol_labels}")),
            (axs[1], labels_after,
             f"After matching{at}"
             + ("" if volume2 is None else f" + labels at vol {volume2}"))):
        lab = np.asarray(lab).astype(np.int64)
        ax[0].imshow(raw.max(axis=2), cmap="gray")
        ax[0].imshow(_label_image(np.ma.masked_equal(lab.max(axis=2), 0)),
                     cmap=cmap, alpha=0.5, interpolation="none")
        ax[0].set_title(f"{title} (x-y)")
        ax[1].imshow(np.repeat(raw.max(axis=0).T, stretch, axis=0),
                     cmap="gray")
        ax[1].imshow(np.repeat(
            _label_image(np.ma.masked_equal(lab.max(axis=0), 0).T),
            stretch, axis=0), cmap=cmap, alpha=0.5, interpolation="none")
        ax[1].set_title(f"{title} (x-z)")
    if path:
        fig.savefig(path, facecolor="white")
        plt.close(fig)
    return fig


def replay_track_animation(anim_dir, volume_range, pattern
                           ="track_anim_t%06i.png"):
    """The saved per-volume figures of ``anim_dir`` as an
    ``ArtistAnimation`` (tracker.py:1433-1460); missing volumes are
    skipped."""
    plt = pyplot()
    from matplotlib import animation
    import matplotlib.image as mgimg
    fig, ax = plt.subplots(figsize=(10, 10), tight_layout=True)
    ax.axis("off")
    frames = []
    for volume in volume_range:
        p = Path(anim_dir) / (pattern % volume)
        if p.exists():
            frames.append([ax.imshow(mgimg.imread(str(p)))])
    return animation.ArtistAnimation(fig, frames, interval=200,
                                     repeat=False)


def draw_segmentation_max_projection(image3d, labels3d, path: Optional[str]
                                     = None):
    """The raw volume and its labels as max projections over z."""
    plt = pyplot()
    fig, (a, b) = plt.subplots(1, 2, figsize=(14, 7))
    a.imshow(np.max(image3d, axis=2), cmap="gray")
    a.set_title("raw (max projection)")
    b.imshow(_label_image(np.max(np.asarray(labels3d).astype(np.int64),
                                 axis=2)),
             cmap=_label_cmap(), interpolation="none")
    b.set_title("segmentation")
    if path:
        fig.savefig(path, facecolor="white")
        plt.close(fig)
    return fig


# ---- the reference's plot helpers by name (track.py:412-498,
# coord_image_transformer.py:760-779) ---------------------------------------

def plot_arrow(ax, x1, y1, x2, y2):
    """A wedge arrow in axes-fraction coordinates."""
    return ax.annotate("", xy=(x2, y2), xycoords="axes fraction",
                       xytext=(x1, y1), textcoords="axes fraction",
                       arrowprops=dict(arrowstyle="wedge", color="C0"))


def _tracking_points(ax, draw_point, ref_ptrs, tgt_ptrs, x_axis, y_axis):
    ax.invert_yaxis()
    if not draw_point:
        return []
    return [ax.scatter(ref_ptrs[:, x_axis], ref_ptrs[:, y_axis],
                       facecolors="none", edgecolors="r"),
            ax.plot(tgt_ptrs[:, x_axis], tgt_ptrs[:, y_axis], "bx")[0]]


def plot_tracking_2d(T_ref, ax, draw_point, ref_ptrs, tgt_ptrs,
                     x_axis, y_axis, sizes):
    """Tracking arrows between two point sets in layer coordinates:
    reference points as hollow red circles, targets as blue crosses, a
    wedge arrow per point in axes fractions of ``sizes``."""
    element = _tracking_points(ax, draw_point, ref_ptrs, tgt_ptrs, x_axis,
                               y_axis)
    for src, dst in zip(np.asarray(ref_ptrs), np.asarray(T_ref)):
        element.append(plot_arrow(
            ax, x1=src[x_axis] / sizes[0], y1=1 - src[y_axis] / sizes[1],
            x2=dst[x_axis] / sizes[0], y2=1 - dst[y_axis] / sizes[1]))
    ax.axis("equal")
    return element


def plot_tracking_2d_realcoord(T_ref, ax, draw_point, ref_ptrs, tgt_ptrs,
                               x_axis, y_axis):
    """Tracking arrows in real coordinates."""
    element = _tracking_points(ax, draw_point, ref_ptrs, tgt_ptrs, x_axis,
                               y_axis)
    for src, dst in zip(np.asarray(ref_ptrs), np.asarray(T_ref)):
        element.append(ax.arrow(
            x=src[x_axis], y=src[y_axis],
            dx=dst[x_axis] - src[x_axis], dy=dst[y_axis] - src[y_axis],
            color="C0", length_includes_head=True, head_length=4,
            head_width=3))
    ax.axis("equal")
    return element


def tracking_plot_xy(ax, ref_ptrs, tgt_ptrs, T_ref, yx_sizes,
                     draw_point=True, layercoord=False):
    """The x-y plane's tracking plot."""
    if layercoord:
        return plot_tracking_2d(T_ref, ax, draw_point, ref_ptrs, tgt_ptrs,
                                1, 0, yx_sizes)
    return plot_tracking_2d_realcoord(T_ref, ax, draw_point, ref_ptrs,
                                      tgt_ptrs, 1, 0)


def tracking_plot_zx(ax, ref_ptrs, tgt_ptrs, T_ref, yz_sizes,
                     draw_point=True, layercoord=True):
    """The z-x plane's tracking plot."""
    if layercoord:
        return plot_tracking_2d(T_ref, ax, draw_point, ref_ptrs, tgt_ptrs,
                                1, 2, yz_sizes)
    return plot_tracking_2d_realcoord(T_ref, ax, draw_point, ref_ptrs,
                                      tgt_ptrs, 1, 2)


def FFN_matching_plot(ref_ptrs, tgt_ptrs, initial_match_score):
    """The greedy peel of an FFN score matrix (deprecated in the reference
    since v0.3): the targets shifted up by twice their y extent, a red
    link for every match peeled above 0.5.  The caller's matrix is left
    as it is."""
    plt = pyplot()
    ref_ptrs = np.asarray(ref_ptrs)
    tgt_shift = np.asarray(tgt_ptrs).copy()
    bias = (tgt_shift[:, 0].max() - tgt_shift[:, 0].min()) * 2
    tgt_shift[:, 0] += bias
    fig = plt.figure(figsize=(9, 9))
    plt.scatter(ref_ptrs[:, 1], -ref_ptrs[:, 0], facecolors="none",
                edgecolors="r")
    plt.plot(tgt_shift[:, 1], -tgt_shift[:, 0], "x")
    plt.axis("equal")
    scores = np.array(initial_match_score, copy=True)
    for _ in range(ref_ptrs.shape[0]):
        if scores.max() < 0.5:
            break
        tgt_i, ref_i = np.unravel_index(scores.argmax(), scores.shape)
        plt.plot([ref_ptrs[ref_i, 1], tgt_shift[tgt_i, 1]],
                 [-ref_ptrs[ref_i, 0], -tgt_shift[tgt_i, 0]], "r-")
        scores[tgt_i, :] = 0
        scores[:, ref_i] = 0
    return fig


def unify_xy_lims(ax1, ax2):
    """Give two axes the limits that hold both."""
    x_lim = [min(ax1.get_xlim()[0], ax2.get_xlim()[0]),
             max(ax1.get_xlim()[1], ax2.get_xlim()[1])]
    y_lim = [min(ax1.get_ylim()[0], ax2.get_ylim()[0]),
             max(ax1.get_ylim()[1], ax2.get_ylim()[1])]
    ax1.set_xlim(x_lim)
    ax1.set_ylim(y_lim)
    ax2.set_xlim(x_lim)
    ax2.set_ylim(y_lim)
