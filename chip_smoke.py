"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them, and the torch/CUDA versions;
2. build: compiles the five hand-written kernel sources from
   ``3deecelltracker_tpu_torch/csrc/`` (with their shared header) with
   ``nvcc``, one each, all at once (into the package's ``_build/``), and
   prints each kernel's registers, spills and static shared memory as
   ``ptxas`` reports them, and the dynamic shared memory per block of both
   conv kernels and of the ladder's channel product and nine-view conv;
3. conv check: the 3x3x3 conv through its router at every 3x3x3 layer
   shape of the bench backbone, and of the legacy U-Net a (a batch of 16
   tiles of (160, 160, 16) and its pooled levels, without the ReLU): the
   kernel that ran (the three-pass TF32 ``wgmma`` kernel, or the direct
   f32 kernel for the c_in = 1 stems) against the plain version (cuDNN with
   TF32 off); per layer its time and TFLOP/s, cuDNN's, the plain version's,
   the f32 bound and the three-pass TF32 bound; for the stems, the direct
   kernel's time beside cuDNN's and its byte bound;
4. flood check: the per-slice flood kernel against its plain version on 24
   slices of 401x168 made from a synthetic label volume with overlaps,
   exactly; its time, its launches per call (one), its rounds (exact) and
   the plain version's (a multiple of ``CHECK_EVERY``), and its tile list
   against ``active_tiles``;
5. cc check: the connected-components kernel against its plain version,
   exactly, on the (401, 168, 24) pipeline frame: the 26-conn 3-D peak mask
   of the bench scene's smoothed EDT, the 8-conn per-slice 2-D peak masks,
   and one serpentine component (3-D and per slice); for each mask its
   launches per call (one), its time per call, its device time from
   ``torch.profiler`` in full and stopped after its first and second phase,
   and the byte bound;
6. the v1.0 slice: ``segment_and_track_arrays`` on the bench scene,
   (24, 401, 168) uint16 volumes with 150 drifting cells (seed 0), at full
   bench width with seeded random weights: 1 reference volume, 1 warm
   volume, 5 timed ones.  Every kernel's launch counter is reset just
   before this run and read just after; the ``wgmma`` conv's and the
   flood's counts must be > 0, the direct conv's one per volume (the stem);
   the flood's launches and rounds are printed;
7. small-scene parity: that slice on a small scene, once on the card and
   once on the CPU (plain versions); see ``phase_small_parity`` for the
   bound;
8. the legacy slice: ``legacy_segment_and_track_arrays`` with U-Net a (the
   reference's ``unet3_a``) on the same scene in the (x, y, z) frame
   (401, 168, 24), 16 tiles per volume, the ``examples/use_unet_legacy.py``
   settings, 1 + 1 + 5 volumes; every counter reset before and read after,
   the ``wgmma`` conv, flood and cc must each be > 0, the direct conv one
   per volume (the stem); the flood's launches and rounds are printed;
9. legacy small-scene parity: the legacy slice on a small scene, card vs
   CPU; see ``phase_legacy_small_parity``;
10. the conv probe: ``scripts.probe_conv_fast.run`` at the backbone's hot
   shape (24, 204, 84), c32 -> c32 and c32 -> c128.  It holds every
   formulation against the plain conv and each ladder kernel against its
   plain version (``add_one`` exactly, the channel product and the
   nine-view conv, at both widths, within ``CONV_RTOL`` / ``CONV_ATOL``),
   and raises on a miss; the phase prints its table (ms, bound, library
   ms, TFLOP/s, and the device time of ``add_one`` and of its library call
   ``x + 1``, of the channel product and of the nine-view conv).  Every
   counter reset before and read after; the ``wgmma`` conv's and each
   ladder kernel's must be > 0, the direct conv's 0.

Every kernel's entry in the kernels line carries its bound: the least time
the card could take, the larger of its bytes (inputs read once, the output
written once) at 3.35 TB/s and its operations at the peak for their type.
That is the 67 TFLOP/s f32 peak, except for the two tensor-core kernels,
the ``wgmma`` conv and the ladder's nine-view conv, whose ``bound_ms``
(the ``wgmma`` conv's also given as ``tc_bound_ms``) counts three TF32
products per multiply at the 495 TFLOP/s dense TF32 peak; their
``f32_bound_ms`` is the same conv's f32 bound, the one the direct kernel is
held to.  The nine-view conv's entry also carries its readings at the
probe's second width (``c128_*``); it, the channel product, ``add_one``
(beside ``x + 1``'s, ``library_device_ms``) and ``cc_label`` (the 3-D peak
mask's; every mask's readings under ``by_mask``) carry their device time
(``device_ms``).

The second-to-last line is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``.  Weights are random: the tracking
accuracy printed is not a measure of the system.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# bench geometry (bench.py:55-74, :184-191, :378-384)
Z, Y, X = 24, 401, 168
N_CELLS = 150
GRID = (1, 2, 2)
VOXEL_SIZE = (1.0, 1.0, 9.2)
N_TIMED = 5
# every 3x3x3 layer of the bench backbone: (z, y, x, c_in, c_out, count)
CONV_LAYERS = [(24, 204, 84, 1, 32, 1), (24, 204, 84, 32, 32, 3),
               (24, 204, 84, 96, 32, 1), (24, 204, 84, 32, 128, 1),
               (12, 102, 42, 32, 64, 1), (12, 102, 42, 64, 64, 2),
               (12, 102, 42, 192, 64, 1), (6, 51, 21, 64, 128, 1),
               (6, 51, 21, 128, 128, 1)]
# tiles per U-Net batch: shrink (24, 24, 2) cuts the scene into 16 tiles
TILE_BATCH = 16
# f32 with a different summation order than cuDNN
CONV_RTOL, CONV_ATOL = 1e-5, 1e-6
# the legacy workflow's settings (examples/use_unet_legacy.py defaults)
LEG_SEG = dict(noise_level=200.0, min_size=100, z_xy_ratio=9.2, z_scaling=10,
               shrink=(24, 24, 2))
LEG_TRACK = dict(beta=300.0, lambda_=0.1, max_iteration=20)
LEG_MAX_CELLS = 512
# stand-in U-Net: a voxel is a cell where its LCN value exceeds 2; at 1.0
# (the default) the bench scene's cells merge into ~40 blobs
LEG_THRESHOLD = 2.0


def unet_conv_layers(spec):
    """{(x, y, z, c_in, c_out): count} of every 3x3x3 layer of ``spec`` on
    one tile, from its block plan: down level l runs on the tile pooled l
    times, up level i on the tile pooled depth - i times, the head on the
    whole tile."""
    depth = len(spec.down_filters)
    plan, _ = spec.block_plan()
    layers = {}
    for name, ci, co in plan:
        if name.startswith("down"):
            level = int(name[4:].split("_")[0])
        elif name.startswith("up"):
            level = depth - int(name[2:].split("_")[0])
        else:
            level = 0
        key = tuple(t // p ** level for t, p in zip(spec.tile_shape,
                                                    spec.pool)) + (ci, co)
        layers[key] = layers.get(key, 0) + 1
    return layers


def stem_count(layers):
    """How many of ``layers``, (c_in, c_out, count) per volume, the direct
    kernel takes (widths off the tensor-core rule: the stems)."""
    from t3dct_torch.ops.hopper_conv import route
    return sum(n for ci, co, n in layers if route(ci, co) == "direct")


def check_flood_launches(path, launches, n_vols):
    """The flood ran on ``path``: print its launches and rounds."""
    n, rounds = launches["flood_slices"], launches["flood_rounds"]
    if n <= 0:
        raise AssertionError(f"{path}: the flood was not launched: "
                             f"{launches}")
    print(f"[{path}] flood: {n} launches ({n / n_vols:.2f} per volume), "
          f"{rounds} rounds ({rounds / n:.1f} per launch)")


def check_conv_launches(path, launches, n_vols, stems):
    """The tensor-core conv ran on ``path``, and the direct kernel exactly
    once per stem layer of each of the ``n_vols`` volumes."""
    want = n_vols * stems
    if launches["conv3x3x3_wgmma"] <= 0 or \
            launches["conv3x3x3_direct"] != want:
        raise AssertionError(f"{path}: conv launches {launches}, want "
                             f"conv3x3x3_wgmma > 0 and conv3x3x3_direct == "
                             f"{want}")


def cuda_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel):
    """The device time of one launch of ``kernel`` (a substring of its
    name) from ``torch.profiler`` (the conv probe's helper); every kernel
    timed so launches once per call of ``fn``."""
    from t3dct_torch.scripts.probe_conv_fast import device_ms as dev_ms
    return dev_ms(fn, kernel)


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from t3dct_torch.utils import cuda_build

    def one(name):
        t0 = time.perf_counter()
        cuda_build.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    names = ("conv3x3x3_wgmma", "conv3x3x3", "flood", "cc", "ladder")
    with ThreadPoolExecutor(len(names)) as pool:    # one nvcc per source
        secs = list(pool.map(one, names))
    for name, sec in zip(names, secs):
        cuda_build.load(name)
        usage = "; ".join(
            f"{k} {r} registers, spills {st}/{ld} B, smem {sm} B"
            for k, r, st, ld, sm in cuda_build.resource_usage(name))
        print(f"[build] {name}: {sec:.2f} s; ptxas: {usage}")
    print(f"[build] all: {time.perf_counter() - t0:.2f} s")
    from t3dct_torch.ops import hopper_conv
    print("[build] conv3x3x3_wgmma dynamic shared memory per block: " +
          ", ".join(f"N tile {nb}: {hopper_conv.wgmma_smem_bytes(nb)} B"
                    for nb in hopper_conv.N_TILES))
    print("[build] conv3x3x3 (direct) dynamic shared memory per block: " +
          ", ".join(f"c_in {ci} tile {t}x{tx}: "
                    f"{hopper_conv.direct_smem_bytes(ci, t, tx)} B"
                    for ci in (1, 12) for t in hopper_conv.DIRECT_TILES
                    for tx in hopper_conv.DIRECT_TX))
    from t3dct_torch.ops import ladder
    print("[build] ladder dynamic shared memory per block: pointwise " +
          ", ".join(f"{ci}->{co}: {ladder.pointwise_smem_bytes(ci, co)} B"
                    for ci, co in ((32, 32), (8, 40), (48, 16))) +
          "; conv9view " +
          ", ".join(f"c_in {ci} c_out {co}: "
                    f"{ladder.conv9view_smem_bytes(co, ci)} B"
                    for ci, co in ((32, 32), (32, 128), (8, 16))))


def conv_row(xin, w, b, relu):
    """One layer: the routed kernel's error against the plain version, and
    times of the routed kernel, the plain version and cuDNN."""
    import torch
    from t3dct_torch.ops import hopper_conv
    from t3dct_torch.utils.roofline import (conv_bound, conv_flop,
                                            conv_tc_bound, library_conv)
    reps, warmup = (5, 1) if xin.dim() == 5 else (10, 2)
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu)
    ref = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = CONV_RTOL * float(ref.abs().max()) + CONV_ATOL
    del got, ref
    ms = cuda_ms(functools.partial(hopper_conv.conv3x3x3_bias_relu, xin, w,
                                   b, relu), reps, warmup)
    return dict(
        kernel=hopper_conv.route(xin.shape[-1], w.shape[-1]), err=err,
        tol=tol, ms=ms,
        plain_ms=cuda_ms(lambda: hopper_conv.conv3x3x3_bias_relu_plain(
            xin, w, b, relu), reps, warmup),
        library_ms=cuda_ms(lambda: library_conv(xin, w, b), reps, warmup),
        bound=conv_bound(xin, w, b), tc_bound=conv_tc_bound(xin, w, b),
        tflops=conv_flop(xin, w.shape[-1]) / ms / 1e9)


def phase_conv(dev):
    """Every 3x3x3 layer of the backbone and of U-Net a through the router;
    per kernel, its layers summed per volume (counts as the models run
    them).  The backbone's sums are each kernel's headline numbers, U-Net
    a's ride along as ``unet_*``."""
    import torch
    from t3dct_torch.models.layers import glorot_uniform
    from t3dct_torch.models.unet3d import unet3_a
    from t3dct_torch.ops import hopper_conv
    gen = torch.Generator().manual_seed(0)
    layers = [("backbone", (z, y, x), ci, co, n, False)
              for z, y, x, ci, co, n in CONV_LAYERS]
    layers += [("unet", shape, ci, co, n, True) for (*shape, ci, co), n
               in unet_conv_layers(unet3_a()).items()]
    out = {k: {} for k in ("wgmma", "direct")}
    for model, shape, ci, co, count, batched in layers:
        lead = (TILE_BATCH,) if batched else ()
        xin = torch.relu(torch.randn(lead + tuple(shape) + (ci,),
                                     generator=gen)).to(dev)
        w = glorot_uniform((3, 3, 3, ci, co), 27 * ci, 27 * co, gen, dev)
        b = (torch.randn((co,), generator=gen) * 0.1).to(dev)
        r = conv_row(xin, w, b, relu=not batched)
        (t_b, by), (t_tc, by_tc) = r["bound"], r["tc_bound"]
        print(f"[conv] {model} {'x'.join(map(str, lead + tuple(shape)))} "
              f"{ci}->{co} x{count}: {r['kernel']} {r['ms']:.3f} ms "
              f"{r['tflops']:.1f} TFLOP/s, max_abs_err {r['err']:.3e} (tol "
              f"{r['tol']:.3e}); cuDNN "
              f"{r['library_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms; "
              f"least f32 {t_b:.4f} ms ({by}), three-pass TF32 "
              f"{t_tc:.4f} ms ({by_tc})")
        if not r["err"] <= r["tol"]:
            raise AssertionError(f"conv {model} {shape} {ci}->{co}: error "
                                 f"{r['err']} > {r['tol']}")
        pre = "unet_" if batched else ""
        acc = out[r["kernel"]]
        acc["max_abs_err"] = max(acc.get("max_abs_err", 0.0), r["err"])
        # a kernel's bound is that of the work it does: f32 FMAs for the
        # direct kernel, three TF32 products per multiply for the wgmma one
        own, own_by = (t_tc, by_tc) if r["kernel"] == "wgmma" else (t_b, by)
        sums = dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=own,
                    library_ms=r["library_ms"])
        if r["kernel"] == "wgmma":
            sums.update(tc_bound_ms=t_tc, f32_bound_ms=t_b)
        for key, v in sums.items():
            acc[pre + key] = acc.get(pre + key, 0.0) + count * v
        if r["kernel"] == "direct":
            dev_ms = device_ms(lambda: hopper_conv.conv3x3x3_direct(
                xin, w, b, not batched), "conv_direct_kernel")
            acc[pre + "device_ms"] = dev_ms
            print(f"[conv] stem {model}: direct {r['ms']:.4f} ms (kernel on "
                  f"the device {fmt_ms(dev_ms)}), cuDNN "
                  f"{r['library_ms']:.4f} ms, least {t_b:.4f} ms ({by}); "
                  f"{r['ms'] / r['library_ms']:.2f}x cuDNN, "
                  f"{r['ms'] / t_b:.2f}x the bound")
        if not batched:
            by_ms = acc.setdefault("_bound_by", {})
            by_ms[own_by] = by_ms.get(own_by, 0.0) + count * own
    for name, acc in out.items():
        by_ms = acc.pop("_bound_by")
        acc["bound_by"] = max(by_ms, key=by_ms.get)
        print(f"[conv] {name} per volume: backbone {acc['ms']:.3f} ms "
              f"(cuDNN {acc['library_ms']:.3f}, least "
              f"{acc['bound_ms']:.3f}); U-Net a {acc['unet_ms']:.3f} ms "
              f"(cuDNN {acc['unet_library_ms']:.3f}, least "
              f"{acc['unet_bound_ms']:.3f})")
    w = out["wgmma"]
    print(f"[conv] wgmma bounds per volume: backbone f32 "
          f"{w['f32_bound_ms']:.3f} / three-pass TF32 {w['tc_bound_ms']:.3f}"
          f" ms; U-Net a f32 {w['unet_f32_bound_ms']:.3f} / three-pass TF32 "
          f"{w['unet_tc_bound_ms']:.3f} ms")
    d = out["direct"]
    print(f"[conv] per volume, routed: backbone "
          f"{out['wgmma']['ms'] + d['ms']:.3f} ms, U-Net a "
          f"{out['wgmma']['unet_ms'] + d['unet_ms']:.3f} ms")
    return out


def synthetic_overlaps(dev, n=N_CELLS, shape=(Y, X, Z), seed=1):
    """recalculate_cell_boundaries' flood inputs from a synthetic label
    volume of overlapping ellipsoids, (x, y, z) pipeline frame."""
    import torch
    from t3dct_torch.ops.edt import distance_transform_edt
    rng = np.random.RandomState(seed)
    sx, sy, sz = shape
    gx, gy, gz = np.meshgrid(np.arange(sx), np.arange(sy), np.arange(sz),
                             indexing="ij")
    seg = np.zeros(shape, np.int32)
    cnt = np.zeros(shape, np.int32)
    for i in range(n):
        c = rng.uniform((8, 8, 2), (sx - 8, sy - 8, sz - 2))
        inside = (((gx - c[0]) / 7.0) ** 2 + ((gy - c[1]) / 7.0) ** 2
                  + ((gz - c[2]) / 2.0) ** 2) < 1.0
        seg += inside * (i + 1)
        cnt += inside
    seg_t = torch.from_numpy(seg).to(dev)
    over = torch.from_numpy(cnt > 1).to(dev)
    markers = torch.where(over, 0, seg_t).to(torch.int32)
    mask = (seg_t > 0) | over
    elev = distance_transform_edt(over.permute(2, 0, 1), (1.0, 1.0),
                                  batch_ndim=1).permute(1, 2, 0).contiguous()
    return elev, markers, mask, int((cnt > 1).sum())


def phase_flood(dev):
    import torch
    from t3dct_torch.ops import hopper_flood
    elev, markers, mask, n_over = synthetic_overlaps(dev)
    flood = hopper_flood.flood_slices
    n0 = flood.launches
    got, rounds = flood(elev, markers, mask)
    launches = flood.launches - n0
    ref, rounds_p = hopper_flood.flood_slices_plain(elev, markers, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"flood: {(got != ref).sum().item()} voxels "
                             "differ from the plain version")
    tiles = hopper_flood.active_tiles(markers, mask)
    every = hopper_flood.CHECK_EVERY
    # the kernel stops at the first quiet round, the plain version at the
    # end of that round's batch of CHECK_EVERY
    if launches != 1 or flood.tiles != tiles or \
            not rounds_p - every < rounds <= rounds_p:
        raise AssertionError(f"flood: {launches} launches, {rounds} rounds "
                             f"(plain {rounds_p}), {flood.tiles} tiles "
                             f"listed of {tiles}")
    t_k = cuda_ms(lambda: flood(elev, markers, mask), reps=5, warmup=1)
    # a call that runs no round: set-up, the labels' write and the host's
    # read of the round count, i.e. what a call costs beside its rounds
    t_0 = cuda_ms(lambda: flood(elev, markers, mask, max_iters=0), reps=5,
                  warmup=1)
    t_p = cuda_ms(lambda: hopper_flood.flood_slices_plain(elev, markers,
                                                          mask),
                  reps=3, warmup=1)
    t_dev = device_ms(lambda: flood(elev, markers, mask), "flood_kernel")
    from t3dct_torch.utils.roofline import bound, nbytes
    t_b, by = bound(0.0, nbytes(elev, markers, mask, got))
    print(f"[flood] {tuple(elev.shape)} overlap voxels {n_over}: exact, "
          f"{launches} launch per call, rounds {rounds} (plain {rounds_p}), "
          f"{tiles} of {-(-elev.numel() // hopper_flood.TILE)} tiles listed"
          f"  kernel {t_k:.3f} ms (no round: {t_0:.3f} ms, so "
          f"{(t_k - t_0) / max(rounds, 1) * 1e3:.1f} us a round; on the "
          f"device {fmt_ms(t_dev)})  plain "
          f"{t_p:.3f} ms  least {t_b * 1e3:.2f} us")
    return dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=t_b,
                bound_by=by, library_ms=None, no_round_ms=t_0,
                device_ms=t_dev,
                rounds_per_call=rounds,
                plain_rounds_per_call=rounds_p)


def phase_cc(dev):
    import torch
    from t3dct_torch.ops import hopper_cc
    from t3dct_torch.ops.edt import distance_transform_edt
    from t3dct_torch.ops.filters import gaussian_filter
    from t3dct_torch.ops.peaks import peak_local_max_mask
    from t3dct_torch.utils.synthetic import make_recording, serpentine
    _, _, lab1 = make_recording(1, N_CELLS, (Z, Y, X))
    cells = torch.from_numpy(lab1.transpose(1, 2, 0) > 0).to(dev)
    # watershed_3d's and watershed_2d's peak masks of the scene's cells
    d3 = gaussian_filter(distance_transform_edt(
        cells, (1.0, 1.0, LEG_SEG["z_xy_ratio"])), (2.0, 2.0, 0.3))
    peaks3 = peak_local_max_mask(d3, 3, exclude_border=0)
    d2 = gaussian_filter(distance_transform_edt(
        cells.permute(2, 0, 1), (1.0, 1.0), batch_ndim=1), 2.0, batch_ndim=1)
    peaks2 = peak_local_max_mask(d2, 7, batch_ndim=1).permute(
        1, 2, 0).contiguous()
    snake = torch.from_numpy(serpentine(tuple(cells.shape))).to(dev)
    from t3dct_torch.utils.roofline import bound, nbytes
    # the mask read once, the int32 labels written once
    t_b, by = bound(0.0, nbytes(peaks3) + 4 * peaks3.numel())
    cc = hopper_cc.cc_label
    reps, warmup = 10, 2
    out = {}
    for name, m, per_slice in (("3-D peaks", peaks3, False),
                               ("per-slice peaks", peaks2, True),
                               ("snake 3-D", snake, False),
                               ("snake per slice", snake, True)):
        n0 = cc.launches
        got = cc(m, per_slice=per_slice)
        ref = hopper_cc.label_components_raw_plain(m, per_slice=per_slice)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"cc {name}: {(got != ref).sum().item()} "
                                 "voxels differ from the plain version")
        if cc.launches != n0 + 1:
            raise AssertionError(f"cc {name}: {cc.launches - n0} launches "
                                 "for one call")
        n0 = cc.launches
        t_k = cuda_ms(lambda: cc(m, per_slice=per_slice), reps, warmup)
        per_call = (cc.launches - n0) / (reps + warmup)
        t_dev = device_ms(lambda: cc(m, per_slice=per_slice), "cc_kernel")
        # the same launch stopped after phase 1, and after phase 2
        t_ph = [device_ms(lambda: hopper_cc._launch(m, per_slice, k),
                          "cc_kernel") for k in (1, 2)]
        t_p = cuda_ms(lambda: hopper_cc.label_components_raw_plain(
            m, per_slice=per_slice), reps=2, warmup=1)
        # a component's root is the voxel labeled with its own index
        nx, ny, nz = m.shape
        own = torch.arange(1, m.numel() + 1, device=dev).reshape(m.shape)
        if per_slice:
            own = torch.arange(1, nx * ny + 1, device=dev).reshape(
                nx, ny, 1)
        n_comp = int((m & (ref == own)).sum())
        print(f"[cc] {name} {tuple(m.shape)}: exact, {int(m.sum())} fg "
              f"voxels, {n_comp} components  kernel {t_k:.4f} ms per call, "
              f"{per_call:g} launch per call, on the device "
              f"{fmt_ms(t_dev)} (through phase 1 {fmt_ms(t_ph[0])}, "
              f"through phase 2 {fmt_ms(t_ph[1])})  plain {t_p:.3f} ms  "
              f"least {t_b * 1e3:.2f} us ({by})")
        out[name] = dict(ms=t_k, device_ms=t_dev, phase1_device_ms=t_ph[0],
                         phase12_device_ms=t_ph[1], plain_ms=t_p,
                         launches_per_call=per_call)
    head = out["3-D peaks"]
    return dict(max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=t_b, bound_by=by, library_ms=None,
                device_ms=head["device_ms"], by_mask=out)


def bench_model(dev, n_rays=96, base=32, feat=128, max_candidates=256,
                render_box=(9, 33, 33), anisotropy=(9.2, 1.0, 1.0)):
    import torch
    from t3dct_torch.config import StarDistConfig
    from t3dct_torch.engine.stardist import StarDist3D
    from t3dct_torch.models.stardist3d import (StarDist3DNet,
                                               with_intensity_path)
    cfg = StarDistConfig(n_rays=n_rays, grid=GRID, anisotropy=anisotropy,
                         unet_n_filter_base=base, net_conv_after_unet=feat,
                         prob_thresh=0.3, nms_thresh=0.3)
    params = with_intensity_path(
        StarDist3DNet(cfg).init(torch.Generator().manual_seed(0), dev), cfg)
    return StarDist3D(cfg, params=params, max_candidates=max_candidates,
                      render_box=render_box, device=dev)


class CudaStageTimer:
    def __init__(self):
        self.times = {}
        self._t = 1

    def stage(self, name):
        import contextlib
        import torch

        @contextlib.contextmanager
        def cm():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            self.times.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))
        return cm()


def counted(fn):
    """``fn()`` with every kernel's launch counter set to 0 just before it;
    returns its result and every counter as read just after it."""
    import torch
    from t3dct_torch.ops import hopper_cc, hopper_conv, hopper_flood, ladder
    wrappers = hopper_conv.KERNELS + (hopper_flood.flood_slices,
                                      hopper_cc.cc_label) + ladder.KERNELS
    for w in wrappers:
        w.launches = 0
    hopper_flood.flood_slices.rounds = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    counts["flood_rounds"] = hopper_flood.flood_slices.rounds
    return out, counts


def phase_slice(dev):
    import torch
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track_arrays
    from t3dct_torch.models.ffn import feature_distance_ffn
    n_vols = 2 + N_TIMED
    t0 = time.perf_counter()
    from t3dct_torch.utils.synthetic import make_recording
    vols, centers, lab1 = make_recording(n_vols, N_CELLS, (Z, Y, X))
    print(f"[slice] scene {len(vols)} x {vols[0].shape} uint16, "
          f"{N_CELLS} cells: {time.perf_counter() - t0:.1f} s")
    model = bench_model(dev)
    ffn = feature_distance_ffn(torch.Generator().manual_seed(1), dev)
    timer = CudaStageTimer()
    t0 = time.perf_counter()
    res, launches = counted(lambda: segment_and_track_arrays(
        vols, model, lab1.transpose(1, 2, 0), ffn, VOXEL_SIZE, 10,
        TrackingConfig(beta=3.0, lambda_=3.0), device=dev, timer=timer))
    wall = time.perf_counter() - t0
    print(f"[slice] wall {wall:.2f} s for {n_vols} volumes (incl. vol-1 "
          f"interpolate); launches {launches}")
    # the v1.0 path runs no mask connected components
    check_conv_launches("v1.0", launches, n_vols, stem_count(
        [(ci, co, n) for *_, ci, co, n in CONV_LAYERS]))
    check_flood_launches("slice", launches, n_vols)
    seg_ms = timer.times["seg"]
    track_ms = timer.times["track"]
    # seg runs for t = 1..n, track for t = 2..n; timed = the last N_TIMED
    seg_t, track_t = seg_ms[-N_TIMED:], track_ms[-N_TIMED:]
    print(f"[slice] per timed volume: seg {np.mean(seg_t):.2f} ms "
          f"{[round(v, 2) for v in seg_t]}, track {np.mean(track_t):.2f} ms "
          f"{[round(v, 2) for v in track_t]}")
    n1 = res.coords[1].shape[0]
    for t in range(1, n_vols + 1):
        c = res.coords[t]
        lab = res.labels[t]
        if c.shape != (n1, 3) or not np.isfinite(c).all():
            raise AssertionError(f"t={t}: coords {c.shape} not finite "
                                 f"(n1={n1})")
        if lab.shape != (Y, X, Z) or lab.dtype != np.uint16:
            raise AssertionError(f"t={t}: labels {lab.shape} {lab.dtype}")
        if t > 1:
            st = res.stats[t]
            print(f"[slice] t={t}: kept {st['kept']}, PR-GLS iterations "
                  f"{st['prgls_iterations']}, correction iterations "
                  f"{st['correction_iterations']}, label ids "
                  f"{int(lab.max())}")
    sc = np.asarray(VOXEL_SIZE)
    errs = []
    for t in range(1, n_vols + 1):
        gt = centers[t][:, [1, 2, 0]] * sc
        d = np.linalg.norm(res.coords[t][:, None] - gt[None], axis=2)
        errs.append(float(np.median(d.min(axis=1))))
    print(f"[slice] vol-1 cells {n1}, kept at t=1 {res.stats[1]['kept']}; "
          f"median distance to the nearest true centre per t (random "
          f"weights, not a measure of accuracy): "
          f"{[round(e, 3) for e in errs]}")
    return launches


def phase_small_parity(dev):
    """The slice on a small scene on the card and on the CPU (plain
    versions).  The f32 PR-GLS carries ~2e-3 real units of rounding noise
    between two summation orders, so a cell whose integer displacement
    sits that close to a rounding boundary can move by one whole step on
    one side: at most one such cell per volume, off by < 1.5, labels
    >= 99.5% equal; every other cell within 1e-3."""
    import torch
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track_arrays
    from t3dct_torch.models.ffn import feature_distance_ffn
    from t3dct_torch.utils.synthetic import make_recording
    vols, _, lab1 = make_recording(4, n_cells=12, shape=(8, 64, 48), seed=1)
    vs = (1.0, 1.13, 4.7)
    out = {}
    for d in (dev, torch.device("cpu")):
        model = bench_model(d, n_rays=32, base=8, feat=16, max_candidates=64,
                            render_box=(5, 17, 17), anisotropy=(4.0, 1, 1))
        ffn = feature_distance_ffn(torch.Generator().manual_seed(1), d)
        out[d.type] = segment_and_track_arrays(
            vols, model, lab1.transpose(1, 2, 0), ffn, vs, 10,
            TrackingConfig(), device=d)
    a, b = out["cuda"], out["cpu"]
    if not np.array_equal(a.auto_vol1, b.auto_vol1):
        raise AssertionError("small scene: vol-1 seg labels differ")
    for t in sorted(b.coords):
        off = np.abs(a.coords[t] - b.coords[t]).max(axis=1)
        same = float((a.labels[t] == b.labels[t]).mean())
        print(f"[parity] small scene t={t}: cells off > 1e-3: "
              f"{int((off > 1e-3).sum())}, max off {off.max():.3e}, labels "
              f"equal {same:.4f}, kept {a.stats[t]['kept']}/"
              f"{b.stats[t]['kept']}, PR-GLS iterations "
              f"{a.stats[t].get('prgls_iterations')}/"
              f"{b.stats[t].get('prgls_iterations')}")
        if (off > 1e-3).sum() > 1 or off.max() >= 1.5 or same < 0.995:
            raise AssertionError(f"small scene t={t}: card and CPU disagree")


def legacy_models(dev, spec, threshold, seed=0):
    import torch
    from t3dct_torch.models.ffn import feature_distance_ffn
    from t3dct_torch.models.unet3d import with_intensity_path
    params, state = spec.init(torch.Generator().manual_seed(seed),
                              device=dev)
    params = with_intensity_path(params, spec, threshold=threshold)
    ffn = feature_distance_ffn(torch.Generator().manual_seed(1), dev)
    return (spec, params, state), ffn


def phase_legacy(dev):
    import torch
    from t3dct_torch.config import SegmentationConfig, TrackingConfig
    from t3dct_torch.engine.legacy import legacy_segment_and_track_arrays
    from t3dct_torch.models.unet3d import unet3_a
    from t3dct_torch.utils.synthetic import make_recording
    n_vols = 2 + N_TIMED
    vols, centers, lab1 = make_recording(n_vols, N_CELLS, (Z, Y, X))
    # the legacy (x, y, z) frame of the raw (z, y, x) volumes
    vols_xyz = [v.transpose(1, 2, 0) for v in vols]
    unet, ffn = legacy_models(dev, unet3_a(), LEG_THRESHOLD)
    timer = CudaStageTimer()
    t0 = time.perf_counter()
    res, launches = counted(lambda: legacy_segment_and_track_arrays(
        vols_xyz, unet, ffn, lab1.transpose(1, 2, 0),
        SegmentationConfig(**LEG_SEG), TrackingConfig(**LEG_TRACK),
        max_cells=LEG_MAX_CELLS, device=dev, timer=timer))
    wall = time.perf_counter() - t0
    print(f"[legacy] U-Net a, {len(vols_xyz)} x {vols_xyz[0].shape} "
          f"(x, y, z), {res.cells[1]} cells at t=1: wall {wall:.2f} s "
          f"(incl. vol-1 interpolate); launches {launches}")
    check_conv_launches("legacy", launches, n_vols, stem_count(
        [(ci, co, n) for (*_, ci, co), n
         in unet_conv_layers(unet3_a()).items()]))
    check_flood_launches("legacy", launches, n_vols)
    if launches["cc_label"] <= 0:
        raise AssertionError(f"a kernel was not launched on the legacy "
                             f"path: {launches}")
    seg_t = timer.times["seg"][-N_TIMED:]
    track_t = timer.times["track"][-N_TIMED:]
    print(f"[legacy] per timed volume: seg {np.mean(seg_t):.2f} ms "
          f"{[round(v, 2) for v in seg_t]}, track {np.mean(track_t):.2f} ms "
          f"{[round(v, 2) for v in track_t]}")
    print(f"[legacy] cells found per volume: {res.cells}")
    if not N_CELLS // 2 <= res.cells[1] <= 2 * N_CELLS:
        raise AssertionError(f"t=1: {res.cells[1]} cells found for the "
                             f"scene's {N_CELLS}")
    n1 = res.coords[1].shape[0]
    sc = np.array([1.0, 1.0, LEG_SEG["z_xy_ratio"]])
    errs = []
    for t in range(1, n_vols + 1):
        c, lab = res.coords[t], res.labels[t]
        if c.shape != (n1, 3) or not np.isfinite(c).all():
            raise AssertionError(f"legacy t={t}: coords {c.shape} not "
                                 f"finite (n1={n1})")
        if lab.shape != (Y, X, Z) or lab.dtype != np.uint16:
            raise AssertionError(f"legacy t={t}: labels {lab.shape} "
                                 f"{lab.dtype}")
        gt = centers[t][:, [1, 2, 0]] * sc
        d = np.linalg.norm(c[:, None] - gt[None], axis=2)
        errs.append(float(np.median(d.min(axis=1))))
    print(f"[legacy] vol-1 cells {n1}; median distance to the nearest true "
          f"centre per t (random weights, not a measure of accuracy): "
          f"{[round(e, 3) for e in errs]}")
    return launches


def phase_legacy_small_parity(dev):
    """The legacy slice on a small scene (tests/test_torch_legacy.py's, 4
    cells, 3 volumes) on the card and on the CPU.  As in
    ``phase_small_parity``, the f32 EM's rounding noise may move one cell
    whose integer displacement sits on a rounding boundary by one whole
    step: at most one cell per volume off by more than 1e-3 (by < 1.5),
    labels >= 99.5% equal; the segmentation counts equal."""
    import torch
    from t3dct_torch.config import SegmentationConfig, TrackingConfig
    from t3dct_torch.engine.legacy import legacy_segment_and_track_arrays
    from t3dct_torch.models.unet3d import UNet3D
    shape, zr = (48, 48, 8), 2.0
    c0 = np.array([[12, 12, 4], [12, 36, 4], [36, 12, 4], [36, 36, 4]],
                  np.float32)
    drift = np.array([[1.5, 0.5, 0], [-1.0, 1.0, 0], [0.5, -1.5, 0],
                      [-0.5, -0.5, 0]], np.float32)
    xx, yy, zz = np.mgrid[:shape[0], :shape[1], :shape[2]]
    vols, lab1 = [], None
    for t in (1, 2, 3):
        img = np.random.RandomState(t).rand(*shape) * 100
        lab = np.zeros(shape, np.int32)
        for i, (cx, cy, cz) in enumerate(c0 + (t - 1) * drift):
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2 + ((zz - cz) * zr) ** 2
            img += 8000 * np.exp(-d2 / 18.0)
            lab[d2 < 16] = i + 1
        vols.append(img.astype(np.float32))
        lab1 = lab if lab1 is None else lab1
    spec = UNet3D(variant="a", tile_shape=(24, 24, 8), pool=(2, 2, 1),
                  down_filters=((4, 4), (4, 8)), up_filters=((8, 8), (4, 4)),
                  head_filters=(4,))
    out = {}
    for d in (dev, torch.device("cpu")):
        unet, ffn = legacy_models(d, spec, threshold=1.0)
        out[d.type] = legacy_segment_and_track_arrays(
            vols, unet, ffn, lab1,
            SegmentationConfig(noise_level=20, min_size=20, z_xy_ratio=zr,
                               z_scaling=2, shrink=(4, 4, 2)),
            TrackingConfig(beta=50.0, lambda_=0.1, max_iteration=10),
            max_cells=64, device=d)
    a, b = out["cuda"], out["cpu"]
    if a.cells != b.cells or not np.array_equal(a.auto_vol1, b.auto_vol1):
        raise AssertionError(f"legacy small scene: segmentations differ "
                             f"({a.cells} vs {b.cells})")
    for t in sorted(b.coords):
        off = np.abs(a.coords[t] - b.coords[t]).max(axis=1)
        same = float((a.labels[t] == b.labels[t]).mean())
        print(f"[legacy parity] small scene t={t}: cells off > 1e-3: "
              f"{int((off > 1e-3).sum())}, max off {off.max():.3e}, labels "
              f"equal {same:.4f}, cells {a.cells.get(t)}")
        if (off > 1e-3).sum() > 1 or off.max() >= 1.5 or same < 0.995:
            raise AssertionError(f"legacy small scene t={t}: card and CPU "
                                 "disagree")


# the ladder's kernels: (probe entry, wrapper name, file:line of the TPU
# kernel they replace)
LADDER = [("pallas_A_passthrough", "ladder_add_one",
           "scripts/probe_conv_fast.py:126"),
          ("pallas_B_dotgeneral", "ladder_pointwise_matmul",
           "scripts/probe_conv_fast.py:145"),
          ("pallas_C_9view_conv", "ladder_conv9view_bias_relu",
           "scripts/probe_conv_fast.py:187")]


def phase_probe(dev):
    from t3dct_torch.ops import ladder
    from t3dct_torch.scripts import probe_conv_fast
    t0 = time.perf_counter()
    res, launches = counted(lambda: probe_conv_fast.run(dev))
    print(f"[probe] shape {res['shape']}: {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    for key, rec in res.items():
        if not isinstance(rec, dict):
            continue
        if "gflop" in rec:
            names = [k[:-3] for k in rec if k.endswith("_ms")
                     and not k.endswith("device_ms")
                     and k not in ("bound_ms", "tc_bound_ms")]
            row = "  ".join(
                f"{n} {rec[n + '_ms']:.3f} ms "
                f"{rec.get(n + '_tflops', rec.get(n + '_eff_tflops')):.1f}"
                f" TFLOP/s" + (f" (err {rec[n + '_maxerr']:.2e})"
                               if n + "_maxerr" in rec else "")
                for n in names)
            dev = (f"; conv9view on the device "
                   f"{fmt_ms(rec['conv9view_device_ms'])}"
                   if "conv9view_device_ms" in rec else "")
            print(f"[probe] {key} ({rec['gflop']:.2f} GFLOP, least "
                  f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}, three-pass"
                  f" TF32 {rec['tc_bound_ms']:.3f} ms): {row}{dev}")
        else:
            lib = rec["library_ms"]
            f32 = (f" (three-pass TF32; f32 {rec['f32_bound_ms']:.4f} ms)"
                   if "f32_bound_ms" in rec else "")
            dev = (f" (on the device {fmt_ms(rec['device_ms'])})"
                   if "device_ms" in rec else "")
            if "library_device_ms" in rec:
                dev += (f" (library on the device "
                        f"{fmt_ms(rec['library_device_ms'])})")
            print(f"[probe] {key}: {rec['ms']:.4f} ms{dev}, least "
                  f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}{f32}, plain "
                  f"{rec['plain_ms']:.4f} ms, library "
                  f"{'-' if lib is None else f'{lib:.4f}'} ms, "
                  f"{rec['tflops']:.2f} TFLOP/s, max_abs_err "
                  f"{rec['maxerr']:.3e} (tol {rec['tol']:.3e})")
    # run() raises on a miss; hold the numbers it recorded all the same
    for key, rec in res.items():
        if isinstance(rec, dict) and "maxerr" in rec:
            if not rec["maxerr"] <= rec["tol"]:
                raise AssertionError(f"probe {key}: {rec['maxerr']} > "
                                     f"{rec['tol']}")
    for name, _, _ in LADDER:
        if not res[name]["ok"]:
            raise AssertionError(f"probe {name} failed")
    missing = [k.__name__ for k in ladder.KERNELS
               if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"a kernel was not launched on the probe "
                             f"path: {launches}")
    # every conv of the probe has c_in 32: no stem
    check_conv_launches("probe", launches, 0, 0)
    return res, launches


def main() -> int:
    if not (ROOT / "3deecelltracker_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import t3dct_torch  # noqa: F401
    from t3dct_torch.utils.device import pin_float32
    pin_float32()
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    conv = phase_conv(dev)
    flood = phase_flood(dev)
    cc = phase_cc(dev)
    launches = phase_slice(dev)
    phase_small_parity(dev)
    leg = phase_legacy(dev)
    phase_legacy_small_parity(dev)
    probe, probe_launches = phase_probe(dev)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    def counts(name):
        by_path = {"v1.0": launches[name], "legacy": leg[name],
                   "probe": probe_launches[name]}
        return dict(launches=sum(by_path.values()),
                    launches_by_path=by_path)

    kernels = [
        dict(name="conv3x3x3_wgmma", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/conv3x3x3_wgmma.cu",
             replaces="3deecelltracker_tpu/ops/pallas_conv.py:89",
             **counts("conv3x3x3_wgmma"), **conv["wgmma"]),
        dict(name="conv3x3x3_direct", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/conv3x3x3.cu",
             replaces="3deecelltracker_tpu/ops/pallas_conv.py:89",
             **counts("conv3x3x3_direct"), **conv["direct"]),
        dict(name="flood_slices", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/flood.cu",
             replaces="3deecelltracker_tpu/ops/pallas_kernels.py:162",
             **counts("flood_slices"), **flood,
             rounds_by_path={"v1.0": launches["flood_rounds"],
                             "legacy": leg["flood_rounds"]}),
        dict(name="cc_label", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/cc.cu",
             replaces="3deecelltracker_tpu/ops/pallas_kernels.py:92",
             **counts("cc_label"), **cc),
    ]
    for entry, name, replaces in LADDER:
        rec = probe[entry]
        extra = {k: rec[k] for k in ("device_ms", "library_device_ms",
                                     "f32_bound_ms") if k in rec}
        if entry == "pallas_C_9view_conv":
            # C at the probe's second width: its width record
            w2 = probe["c32_to_c128"]
            extra.update(c128_ms=w2["conv9view_ms"],
                         c128_device_ms=w2["conv9view_device_ms"],
                         c128_max_abs_err=w2["conv9view_maxerr"],
                         c128_bound_ms=w2["tc_bound_ms"],
                         c128_f32_bound_ms=w2["bound_ms"],
                         c128_library_ms=w2["library_ms"])
        kernels.append(dict(
            name=name, route="cuda",
            source="3deecelltracker_tpu_torch/csrc/ladder.cu",
            replaces=replaces, **counts(name), max_abs_err=rec["maxerr"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            **extra))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
