"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them, the torch/CUDA versions, and
   whether ``h5py`` and ``matplotlib`` import; without ``h5py``, an HDF5
   recording and a Keras ``.h5`` checkpoint must raise an ``ImportError``
   that names it (``check_hdf5_raises``);
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
   settings, 1 + 1 + 5 volumes, in float32 (phase 23 runs JAX's default,
   bfloat16); every counter reset before and read after,
   the ``wgmma`` conv, flood and cc must each be > 0, the direct conv one
   per volume (the stem); the flood's launches and rounds are printed;
9. legacy small-scene parity: the legacy slice on a small scene, card vs
   CPU, in float32; see ``phase_legacy_small_parity``;
10. the conv probe: ``scripts.probe_conv_fast.run`` at the backbone's hot
   shape (24, 204, 84), c32 -> c32 and c32 -> c128.  It holds every
   formulation against the plain conv and each ladder kernel against its
   plain version (``add_one`` exactly, the channel product and the
   nine-view conv, at both widths, within ``CONV_RTOL`` / ``CONV_ATOL``),
   and raises on a miss; the phase prints its table (ms, bound, library
   ms, TFLOP/s, and the device time of ``add_one`` and of its library call
   ``x + 1``, of the channel product and of the nine-view conv).  Every
   counter reset before and read after; the ``wgmma`` conv's and each
   ladder kernel's must be > 0, the direct conv's 0;
11. bench scene, trained weights, real entry point: the bench scene's 21
   volumes written as TIFF slices with the ``manual_vol1`` labels (the
   port's codec), then ``engine.pipeline.segment_and_track`` with
   ``handoff="device"`` and the committed weights
   (``3deecelltracker_tpu_torch/assets/bench/``) into a fresh results
   tree, held to JAX's record of the same run (``jax_record.npz``): kept
   cells per volume exact (one candidate within ``KEPT_MARGIN`` of a
   threshold may differ, and is printed with its margin), tracked
   coordinates within ``COORD_MEDIAN`` per volume and every cell within
   the record's identity gate of JAX's same cell, labels
   ``LABELS_EQUAL`` per recorded volume, strict recall and identity
   switches equal.  Every counter reset before and read after; the
   ``wgmma`` conv's and the flood's must be > 0, the direct conv's one per
   volume.  Prints the wall per volume of the whole call (host I/O
   included), seg and track per volume, strict recall, accuracy over
   every t and identity switches, with the card's name and power limit.

12. disk handoff: ``segment_and_track(handoff="disk")`` over phase 11's
   TIFFs, held to the same record and its ``seg/`` to phase 11's;
13. ensemble: ``track_timelapse`` in ensemble mode (20 samples) over phase
   12's ``seg/``, held to ``jax_record_ensemble.npz``, then the activities;
14. the trainers (``bench.py``'s recipe, the records in
   ``3deecelltracker_tpu_torch/assets/train/``): (1) the conv's autograd
   Function's dX, dW and db against autograd through the plain version
   in float64 (with the Function's ReLU mask; the voxels whose mask differs from
   cuDNN's are counted) at every 3x3x3 layer shape of the recipe's network
   on its (2, 24, 48, 48) patch batch after the grid pool, stem included,
   within ``GRAD_RTOL`` in the norm, with the forward's, dX's (kernel) and dW's (library) times
   and bounds per step; (2) the first 30 steps of ``TrainStarDist3D`` and
   of ``TrainFFN`` from JAX's initial parameters and seed, their losses
   held to JAX's record (steps 1-5 within ``LOSS_FIRST_TOL``, then
   ``LOSS_LATER_TOL``; StarDist's per step through ``LOSS_PER_STEP``, or
   within twice JAX's own spread under one-ulp nudges of its init where
   that is larger, then by the mean of the rest within twice theirs, and
   faults planted in the conv's backward (``PLANTED``) must fail; the FFN
   on JAX's
   normalized cloud, its lattice ties decided by the normalization's last
   bit), the first step at which they part by more than ``LOSS_PART``
   printed, and the conv's launches in one step's forward and backward; (3) the whole recipe from JAX's inits (16 x 30 StarDist
   steps; 600 FFN iterations on the card-trained model's vol-1 cloud),
   saved and run through ``segment_and_track(handoff="device")`` over
   phase 11's recording: cells at t = 1 against ``bench.py``'s bar, GT
   cells matched at IoU 0.5 (``MIN_MATCHED``), strict recall
   (``MIN_RECALL``) and identity switches (``MAX_SWITCHES``), beside the
   JAX-trained weights'; ms per StarDist step (and by stage) and per FFN
   iteration.  Every counter is reset before the training and read after
   it (the path ``train``): each step launches the conv kernels the
   forward and the backward's dX take, and nothing else;
15. the per-volume API (path ``api``): ``predict_instances`` (sparse,
   dense, ``return_predict``) and ``predict`` with the trained weights on
   vol 1 of phase 11's recording, bit-equal to ``predict_instances_device``
   + ``finalize_instances`` and to ``forward_grid``'s crop;
16. tiled StarDist over the bench scene (path ``tiled``):
   ``predict_and_save(tile_shape=(None, 256, None))`` over phase 11's
   TIFFs with the trained weights (4 tiles a volume, one batched backbone
   call), then ``track_timelapse``, held to ``jax_record_tiled.npz`` with
   phase 11's bounds; the kept cells beyond the receptive field of the y
   faces must all be phase 11's; prints seg and track ms per volume, conv
   launches per volume, and one batched backbone call beside its bound and
   the whole-volume backbone; every conv layer of the backbone at the
   sweep's tile batch (4 x (24, 128, 84) on the grid) against the plain
   version;
17. zebrafish scale (path ``zebrafish``): ``examples/segment_large_volume.
   py``'s config with a seeded init on its (64, 512, 512) volume, 49 tiles
   of (None, 192, 192): the tiled prob map against the whole-volume pass
   beyond the receptive field (``TILED_INTERIOR_ATOL``), ``tile_batch`` 8
   against 1 bit for bit, and ``scripts.segment_large_volume.main`` with
   the example's settings (seconds per volume, launches, peak memory
   beside the whole-volume program's; random weights keep no instance
   there, so the same sweep is also timed at the threshold of the batch
   check, with instances for its NMS and render); every conv layer of the
   backbone at the tile batches' shapes (8 and 1 x (32, 48, 48) on the
   grid) and the whole volume's ((32, 128, 128)) against the plain
   version; each tiled run's direct conv launches once per tile batch.
   The whole-volume pass is no tiled run: its launches are printed and
   kept out of the path's count;
18. the legacy folder workflow, trained (path ``legacy_folder``): the
   bench scene's 21 volumes as ``raw_t%04i_z%04i.tif`` slices with the
   ground truth in ``manual_vol1/`` and, in ``models/``, U-Net a trained by
   JAX's ``TrainingUNet3D`` and the bench FFN
   (``3deecelltracker_tpu_torch/assets/legacy/``); the
   ``examples/use_unet_legacy.py`` flow through the folder ``Tracker``
   (``load_unet``, ``load_ffn``, ``segment_vol1``, ``load_manual_seg``,
   ``interpolate_seg``, ``cal_subregions``, ``initiate_tracking``,
   ``track(2)``, ``save_coordinates``) from an empty U-Net cache, its
   segmenter built in float32 (``legacy_tracker(f32=True)``), held to
   ``jax_legacy_record.npz`` (``hold_legacy_to_record``: cells per volume,
   ``auto_vol1`` and labels, coordinates by median and the identity gate,
   recall, switches; the GT cells matched at t = 1 printed), every counter
   reset before and read after (the ``wgmma`` conv, one stem per volume,
   the flood and cc); seg and track ms per volume and the wall per volume;
19. the same folder with ``ensemble=20`` (path ``legacy_ensemble``), its
   U-Net cache cleared, held to ``jax_legacy_record_ensemble.npz`` with
   the same counters;
20. retraining (path ``retrain``): the conv Function's gradients at every
   3x3x3 layer of U-Net a's training batch (8 x (160, 160, 16) and its
   pooled levels, no ReLU) against float64 autograd; the first 30 steps of
   ``retrain_unet`` on JAX's batches (``jax_unet_train_record.npz``: its
   patch starts and affine draws), losses per step and the mean update
   norm of every leaf held to the record, the dW-zeroed fault rejected;
   ``scripts/use_unet_legacy.py --retrain 2`` in a fresh folder (min_size
   20: the bench cells are smaller than the example's 100); ms per
   step with the forward's, dX's and dW's per step beside their bounds;
21. U-Net variants b and c: every 3x3x3 layer shape of a bench volume's
   tile batch against the plain version, and vol 1's segmentation through
   ``Tracker(unet_variant=...)`` with seeded weights on the card, and on a
   crop on the card against the CPU;
22. the reference's Keras topology (paths ``keras`` and ``keras_tiled``):
   the committed seeded ``arch="keras"`` model (``assets/keras/sd_keras/``,
   converted once from a reference stardist folder, loaded without
   ``h5py``) at the bench config: every 3x3x3 layer at the bench volume's
   shapes against the plain version, the full-resolution pre0_0 and
   pre0_1 printed beside cuDNN and their bounds; volume 1's prob and dist
   maps through the kernels against the network's plain version on the
   card and against JAX's record (``jax_record_keras.npz``); then
   ``segment_and_track(handoff="device")`` over phase 11's TIFFs, held to
   that record with phase 11's rules (labels ``KERAS_LABELS_EQUAL``), seg
   and track ms per volume; and ``predict_instances_tiled`` of volume 1
   whose prob map equals the whole pass beyond the Keras receptive field
   of the tiled faces;
23. JAX's default precision on the legacy path (paths ``legacy_bf16`` and
   ``legacy_bf16_ensemble``): every 3x3x3 layer shape of U-Net a's tile
   batch and its pooled levels, of variants b and c and of the bench
   backbone in both archs through the router in bfloat16 against the plain
   bf16 version (an f32 conv of the bf16-rounded operands) within
   ``BF16_RTOL`` of sum |x w| + |b|, each with its time, TFLOP/s, bf16
   bound, cuDNN's bf16 time and the TF32 kernel's time on the shape; U-Net
   a's ms a volume in bf16 beside f32; then phase 18's folder flow with
   the ``Tracker`` as JAX builds it (bfloat16) over the 21 volumes and
   with ``ensemble=20``, held to ``jax_legacy_record_bf16.npz`` /
   ``jax_legacy_record_ensemble_bf16.npz`` within twice JAX's own spread
   (its eleven nudged runs, ``jax_legacy_record_bf16_nudged*.npz``: vol
   1's probabilities, cells, labels, coordinates, recall, switches;
   ``hold_legacy_bf16``), every counter reset before and read after (the bf16 ``wgmma`` conv, the bf16
   stem once per volume, no f32 conv, the flood and cc), seg and track
   ms per volume;
24. non-finite activations in the bf16 kernel's half chunk (``ROADMAP.md``
   C.10): U-Net a's c_in % 16 == 8 shapes (8 -> 16, 8 -> 8) in the f32-out
   layer mode and the block mode, with +Inf, -Inf and NaN planted in
   single activations: the kernel equals the plain version exactly where
   that is not finite, and holds it within ``BF16_RTOL`` elsewhere
   (``nonfinite_rows``; those launches are no path's);
25. the mesh (paths ``mesh_bench``, ``mesh_ensemble``, ``mesh_sharded``,
   ``mesh_unet_tiles``, ``mesh_unet_halo``): an NCCL world of one
   (``parallel.multihost.initialize`` over a ``FileStore`` in the run's
   temporary directory, destroyed at the end), ``make_mesh(1)``, then
   ``segment_and_track(mesh=, handoff="device")`` over phase 11's TIFFs,
   ensemble ``track_timelapse(mesh=)`` over phase 12's ``seg/``,
   ``predict_instances_sharded`` on phase 17's volume and the
   ``UNetSegmenter`` (trained U-Net a, bf16) on the legacy folder's vol 1
   in ``mesh_mode="tiles"`` and ``"halo"``, each held bit for bit against
   what it is made of: phase 11's and 13's trees and coordinates,
   ``predict_instances_tiled`` on the same volume, the segmenter without a
   mesh, and the U-Net applied straight to the zero-extended padded
   volume; ms per volume beside the runs without a mesh;
26. the synthetic demo (path ``demo``): ``scripts.synthetic_demo.main`` on
   the card, the example's whole recipe, each stage's seconds and the
   median tracking error at t = 6 against ``DEMO_MAX_ERROR``;
27. mesh training (paths ``mesh_train_stardist``, ``mesh_train_ffn``,
   ``mesh_train_unet``): an NCCL world of one again, then phase 14's 30
   StarDist steps and 30 FFN iterations from JAX's inits with
   ``mesh=make_mesh(1)`` (and once more without, timed the same way), and
   phase 20's 30 U-Net a steps on JAX's batches through
   ``TrainingUNet3D(mesh=make_mesh(1, 1))``, whose steps are
   ``make_sharded_unet_train_step``'s (the halo path at spatial size 1:
   zero halos, the conv kernels on the x + 2 shapes, the synchronized
   BatchNorm, one all-reduce a step).  Each mesh run is held to JAX's
   record with phase 14's or 20's gates and to the run without a mesh
   (``MESH_*``: the CPU tests' tolerances), with the same conv launches a
   step; prints ms per step beside the run without a mesh and the
   parameters' departure from it.

Every kernel's entry in the kernels line carries its bound: the least time
the card could take, the larger of its bytes (inputs read once, the output
written once) at 3.35 TB/s and its operations at the peak for their type.
That is the 67 TFLOP/s f32 peak, except for the tensor-core kernels,
the ``wgmma`` conv and the ladder's nine-view conv, whose ``bound_ms``
(the ``wgmma`` conv's also given as ``tc_bound_ms``) counts three TF32
products per multiply at the 495 TFLOP/s dense TF32 peak; their
``f32_bound_ms`` is the same conv's f32 bound, the one the direct kernel is
held to.  The nine-view conv's entry also carries its readings at the
probe's second width (``c128_*``).  The bf16 ``wgmma`` conv's
``bound_ms`` counts one pass at the 989 TFLOP/s dense bf16 peak over U-Net
a's layers per volume (its headline numbers are U-Net a's, the backbone's
ride along as ``backbone_*``, the TF32 kernel's time on the same layers as
``tf32_ms``); the bf16 stem's is the direct kernel's bytes and f32 FMAs.
The nine-view conv, the channel product, ``add_one``
(beside ``x + 1``'s, ``library_device_ms``) and ``cc_label`` (the 3-D peak
mask's; every mask's readings under ``by_mask``) carry their device time
(``device_ms``).

The conv's entry also carries phase 14's sums per training step
(``train_fwd_ms``, ``train_dx_ms`` with ``train_dx_flip_pack_ms``,
``train_dx_bound_ms``, ``train_dx_library_ms``, ``train_dw_ms`` (the
library's), ``train_dw_bound_ms``, ``train_grad_max_rel_err``) and its
training times (``sd_step_ms``, ``ffn_iter_ms``, ``step_*_ms``).

The second-to-last line is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``.  Phases 6-9 use seeded random weights,
so the tracking accuracy they print is not a measure of the system;
phases 11-13, 15 and 16 use the trained weights, phase 14 weights it
trains, phase 17 a seeded init.  The conv's entry also carries phase 16's
and 17's readings (``tiled_*``, ``whole_backbone_*``, ``zebrafish_*``);
both conv entries' ``max_abs_err`` is the largest over every shape held
against the plain version, phases 16 and 17's included
(``tiled_max_abs_err``, ``zebrafish_max_abs_err``, and phase 21's
``variants_max_abs_err``), and phases 18-20's readings (``legacy_*``,
``legacy_ensemble_*``, ``unet_step_ms``, ``unet_train_*``).  Phases 18-19
use the JAX-trained U-Net, phase 20 retrains it, phase 21 seeded weights.
Phase 22's readings ride on the conv entries (``keras_*``: per kernel its
layers' sums, pre0_0's and pre0_1's times, the network's ms, seg and track
ms per volume) and its launches under ``keras`` and ``keras_tiled``.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import tempfile
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
# phase 11: the bench scene's 21 volumes through ``segment_and_track``
# with the trained weights, held to JAX's record of the same run
BENCH_VOLS = 21
ASSETS = ROOT / "3deecelltracker_tpu_torch" / "assets" / "bench"
# one candidate may be kept on one side only if it sits this close to a
# threshold (prob, or NMS overlap)
KEPT_MARGIN = 1e-4
# tracked coordinates against JAX's (real units): the median per volume
# within the slice tests' 1e-2.  No per-cell bound below a voxel holds: the
# f32 PR-GLS EM of the two frameworks parts by ~1e-2 on the bench scene
# with equal inputs (JAX's own output moves 2e-3 for a 1-ulp input
# change), and the correction loop's integer rounding turns that into a
# whole voxel step for a cell near a rounding boundary, which later volumes
# can carry on.  So every cell is held to JAX's cell of the same identity:
# within the record's identity gate (half the median nearest-neighbour
# spacing of the true t = 1 cloud), the gate of the strict-recall metric.
COORD_MEDIAN = 1e-2
# share of voxels equal per recorded label volume (the slice tests' bound)
LABELS_EQUAL = 0.995


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
    # whether the machine reads HDF5 (recordings, Keras .h5 checkpoints)
    # and draws figures (ROADMAP.md A.9)
    import importlib.util
    print("[device] packages: " + ", ".join(
        f"{m} {'imports' if importlib.util.find_spec(m) else 'missing'}"
        for m in ("h5py", "matplotlib")))
    if importlib.util.find_spec("h5py") is None:
        check_hdf5_raises()
    return smi


def check_hdf5_raises():
    """Without ``h5py`` an HDF5 recording and a Keras ``.h5`` checkpoint
    raise an ``ImportError`` that names it (no second reader, no
    fallback)."""
    from t3dct_torch.io.imageio import get_t_range, load_2d_slices_at_time
    from t3dct_torch.utils.keras_import import import_ffn, read_keras_h5
    rec = {"h5_file": "recording.h5", "channel": 0}
    calls = {"load_2d_slices_at_time": lambda: load_2d_slices_at_time(rec,
                                                                      1),
             "get_t_range": lambda: get_t_range(rec),
             "read_keras_h5": lambda: read_keras_h5("weights_best.h5"),
             "import_ffn": lambda: import_ffn("ffn.h5")}
    for name, call in calls.items():
        try:
            call()
        except ImportError as e:
            if "h5py" not in str(e):
                raise AssertionError(f"{name}: {e!r} does not name h5py")
            continue
        raise AssertionError(f"{name} ran without h5py")
    print(f"[device] without h5py the HDF5 halves raise ImportError naming "
          f"it: {', '.join(calls)}")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from t3dct_torch.utils import cuda_build

    def one(name):
        t0 = time.perf_counter()
        cuda_build.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    names = ("conv3x3x3_wgmma", "conv3x3x3", "conv3x3x3_wgmma_bf16",
             "conv3x3x3_bf16", "flood", "cc", "ladder")
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
    print("[build] conv3x3x3_wgmma_bf16 pipeline (resident weights or "
          "streamed, stages, dynamic shared memory, blocks an SM, 8 x 8 "
          "tiles a warpgroup) at c_in 8 / 64 / 256: " + "; ".join(
              f"N tile {nb}: " + ", ".join(
                  "{resident}/{stages}/{smem} B/{blocks}/{mt}".format(
                      **hopper_conv.wgmma_bf16_plan(nb, ci))
                  for ci in (8, 64, 256)) for nb in hopper_conv.N_TILES))
    print("[build] conv3x3x3_bf16 (stem) dynamic shared memory per block: " +
          ", ".join(f"tile {t}x{tx}: {hopper_conv.stem_smem_bytes(t, tx)} B"
                    for t in hopper_conv.DIRECT_TILES
                    for tx in hopper_conv.STEM_TX))
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


def conv_err(xin, w, b, relu):
    """One layer through the router against the plain version: ``(kernel,
    max_abs_err, tol)``, the tolerance ``CONV_RTOL`` of the plain output's
    largest magnitude plus ``CONV_ATOL``."""
    import torch
    from t3dct_torch.ops import hopper_conv
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu)
    ref = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = CONV_RTOL * float(ref.abs().max()) + CONV_ATOL
    return hopper_conv.route(xin.shape[-1], w.shape[-1]), err, tol


def conv_row(xin, w, b, relu):
    """One layer: the routed kernel's error against the plain version, and
    times of the routed kernel, the plain version and cuDNN."""
    from t3dct_torch.ops import hopper_conv
    from t3dct_torch.utils.roofline import (conv_bound, conv_flop,
                                            conv_tc_bound, library_conv)
    reps, warmup = (5, 1) if xin.dim() == 5 else (10, 2)
    kernel, err, tol = conv_err(xin, w, b, relu)
    ms = cuda_ms(functools.partial(hopper_conv.conv3x3x3_bias_relu, xin, w,
                                   b, relu), reps, warmup)
    return dict(
        kernel=kernel, err=err, tol=tol, ms=ms,
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
    from t3dct_torch.utils.timing import CudaStageTimer
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
    from t3dct_torch.utils.timing import CudaStageTimer
    timer = CudaStageTimer()
    t0 = time.perf_counter()
    res, launches = counted(lambda: legacy_segment_and_track_arrays(
        vols_xyz, unet, ffn, lab1.transpose(1, 2, 0),
        SegmentationConfig(**LEG_SEG), TrackingConfig(**LEG_TRACK),
        max_cells=LEG_MAX_CELLS, device=dev, timer=timer,
        compute_dtype=torch.float32))
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
            max_cells=64, device=d, compute_dtype=torch.float32)
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


def write_bench_scene(root):
    """The bench scene as ``bench.py`` writes it (``make_recording``,
    ``_save_manual_vol1``): per-(t, z) uint16 TIFF slices of the 21 volumes,
    and the vol-1 ground truth as the proofed ``manual_vol1`` labels, with
    the port's codec.  Returns the recording's pattern and the true
    centres."""
    from t3dct_torch.io.imageio import save_label_slices
    from t3dct_torch.utils.synthetic import make_recording
    vols, centers, lab1 = make_recording(BENCH_VOLS, N_CELLS, (Z, Y, X))
    for t, v in enumerate(vols, start=1):
        save_label_slices(v.transpose(1, 2, 0), root / "raw",
                          "raw_t%03i_z%04i.tif", t, use_8_bit=False,
                          compression=None)
    save_label_slices(lab1.transpose(1, 2, 0), root / "results" /
                      "manual_vol1", "manual_vol1_t%04i_z%04i.tif", 0,
                      use_8_bit=False, compression=None)
    return str(root / "raw" / "raw_t%03i_z*.tif"), centers


def kept_difference(t, got_zyx, want_zyx, cands, model):
    """Candidates that one side kept and the other did not at volume
    ``t``, each with its margin: the distance of its probability to the
    prob threshold, or of its overlap with another candidate to the NMS
    threshold, whichever is less (from this run's candidates)."""
    import torch
    from t3dct_torch.ops.nms import overlap_matrix
    got = {tuple(int(v) for v in p) for p in got_zyx}
    want = {tuple(int(v) for v in p) for p in want_zyx}
    if got == want:
        return []
    kept, probs, dists, points = cands
    ov = overlap_matrix(points.to(torch.float32), dists, model.rays,
                        torch.ones_like(kept), prob=probs).cpu().numpy()
    np.fill_diagonal(ov, np.inf)
    probs, points = probs.cpu().numpy(), points.cpu().numpy()
    out = []
    for p in sorted(got ^ want):
        i = np.flatnonzero((points == p).all(axis=1))
        side = "card" if p in got else "JAX"
        if i.size == 0:
            out.append((t, p, side, np.inf))
            continue
        i = int(i[0])
        margin = min(abs(float(probs[i]) - model.thresholds["prob"]),
                     float(np.abs(np.concatenate([ov[i], ov[:, i]])
                                  - model.thresholds["nms"]).min()))
        out.append((t, p, side, margin))
    return out


def trained_model(dev, cands, method="predict_instances_device"):
    """The committed StarDist model with ``bench_composition``'s settings,
    keeping its candidates in ``cands`` (``keep_candidates``)."""
    from t3dct_torch.engine.stardist import StarDist3D
    model = StarDist3D.load(ASSETS / "sd_model", device=dev)
    return keep_candidates(model, cands, method)


def keep_candidates(model, cands, method="predict_instances_device"):
    """``model`` with ``bench_composition``'s settings; the candidates of
    each call of its seg program ``method`` are appended to ``cands`` (for
    the kept cells' margins)."""
    model.max_candidates, model.render_box = 256, (9, 33, 33)
    seg = getattr(model, method)

    def kept(*args, **kwargs):
        out = seg(*args, **kwargs)
        cands.append(out[:4])
        return out

    setattr(model, method, kept)
    return model


def hold_to_record(path, record, results, coords, centers, cands, model,
                   labels_equal=LABELS_EQUAL):
    """The bench phases' checks of a run against a JAX record: kept cells
    exact per volume (one candidate within ``KEPT_MARGIN`` of a threshold
    may differ; without ``cands`` none may), tracked coordinates within
    ``COORD_MEDIAN`` per volume and every cell within the record's
    identity gate, labels ``labels_equal`` per recorded volume, strict
    recall and identity switches equal.  Prints a line per volume; returns
    (what failed, this run's metrics, the record's)."""
    from t3dct_torch.engine.metrics import tracking_id_metrics
    from t3dct_torch.io.imageio import imread_stack
    want_metrics = json.loads(str(record["metrics"]))
    diffs, kept = [], []
    for t in range(1, BENCH_VOLS + 1):
        got = np.load(results / "seg" / f"coords{t:06d}.npy")
        want = record[f"seg_coords_{t}"]
        kept.append((len(got), len(want)))
        if cands is None:
            if got.shape != want.shape or not (got == want).all():
                diffs.append((t, "seg coordinates", "card", np.inf))
            continue
        diffs += kept_difference(t, got[:, [2, 0, 1]], want[:, [2, 0, 1]],
                                 cands[t - 1], model)
    for t, p, side, margin in diffs:
        print(f"[{path}] t={t}: candidate {p} kept on the {side} side "
              f"only, margin {margin:.3e}")
    print(f"[{path}] kept per volume (card, JAX): {kept}")
    bad = []
    if len(diffs) > 1 or any(m > KEPT_MARGIN for *_, m in diffs):
        bad.append(f"kept cells {diffs}")
    for t in range(1, BENCH_VOLS + 1):
        d = np.linalg.norm(coords[t] - record[f"coords_{t}"], axis=1)
        line = (f"[{path}] t={t}: coords off JAX's record by median "
                f"{np.median(d):.3e}, max {d.max():.3e} real units "
                f"(cell {int(d.argmax())}), {int((d > 1e-2).sum())} "
                f"cells beyond 1e-2, {int((d > 0.5).sum())} beyond 0.5")
        if not np.isfinite(coords[t]).all() or \
                np.median(d) > COORD_MEDIAN or \
                d.max() > want_metrics["gate"]:
            bad.append(f"t={t} coords")
        key = f"labels_{t}"
        if key in record:
            lab = imread_stack(sorted((results / "track_results" /
                                       "labels").glob(
                "track_results_t%06i_z*.tif" % t))).transpose(1, 2, 0)
            same = float((lab == record[key]).mean())
            line += f"; labels equal {same:.5f}"
            if lab.dtype != record[key].dtype or same < labels_equal:
                bad.append(f"t={t} labels")
        print(line)
    # where a cell parts from JAX's by more than a voxel step: how far
    # each run's cell is from its true centre (identities from t = 1)
    sc = np.asarray(VOXEL_SIZE)
    gt = {t: centers[t][:, [1, 2, 0]] * sc for t in centers}
    ident = np.linalg.norm(coords[1][:, None] - gt[1][None], axis=2
                           ).argmin(axis=1)
    for t in range(1, BENCH_VOLS + 1):
        d = np.linalg.norm(coords[t] - record[f"coords_{t}"], axis=1)
        for i in np.flatnonzero(d > 1.0):
            truth = gt[t][ident[i]]
            print(f"[{path}] t={t}: cell {i} {d[i]:.3f} real units off "
                  f"JAX's; from its true centre: card "
                  f"{np.linalg.norm(coords[t][i] - truth):.3f}, JAX "
                  f"{np.linalg.norm(record[f'coords_{t}'][i] - truth):.3f}")
    got_metrics = tracking_id_metrics(coords, centers, VOXEL_SIZE,
                                      BENCH_VOLS)
    print(f"[{path}] strict recall {got_metrics['strict_recall']}, "
          f"accuracy over every t {got_metrics['strict_accuracy_all_t']}, "
          f"identity switches {got_metrics['id_switches']} (JAX's record: "
          f"{want_metrics})")
    bad += [f"{key} {got_metrics[key]}" for key in ("strict_recall",
                                                     "id_switches")
            if got_metrics[key] != want_metrics[key]]
    return bad, got_metrics, want_metrics


# phases 11 and 13's wall ms per volume, printed beside phase 25's
WALLS = {}


def phase_bench_scene(dev, smi, root):
    """Phase 11: the bench scene through the real entry point with the
    trained weights and ``handoff="device"``, held to JAX's record of the
    same run (``assets/bench/jax_record.npz``).  Leaves the recording and
    its results tree in ``root`` for phases 12 and 13."""
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track
    from t3dct_torch.utils.timing import CudaStageTimer
    record = np.load(ASSETS / "jax_record.npz")
    t0 = time.perf_counter()
    pattern, centers = write_bench_scene(root)
    print(f"[bench] scene: {BENCH_VOLS} volumes of {(Z, Y, X)} uint16 "
          f"as TIFF slices, {N_CELLS} cells: "
          f"{time.perf_counter() - t0:.1f} s")
    cands = []
    model = trained_model(dev, cands)
    timer = CudaStageTimer()
    results = root / "results"
    coords, launches = counted(lambda: segment_and_track(
        pattern, model, results, str(results / "manual_vol1" / "*.tif"),
        ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS),
        TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        timer=timer, handoff="device", device=dev))
    print(f"[bench] launches {launches}")
    check_conv_launches("bench", launches, BENCH_VOLS, stem_count(
        [(ci, co, n) for *_, ci, co, n in CONV_LAYERS]))
    check_flood_launches("bench", launches, BENCH_VOLS)
    bad, _, _ = hold_to_record("bench", record, results, coords, centers,
                               cands, model)
    wall = timer.times["call"][0] / BENCH_VOLS
    WALLS["bench"] = wall
    seg_ms, track_ms = np.mean(timer.times["seg"]), \
        np.mean(timer.times["track"])
    print(f"[bench] {smi}: wall {wall:.2f} ms per volume for the whole call "
          f"(TIFF decode, percentiles, uploads, artifacts, vol-1 "
          f"interpolation {timer.times['interpolate_vol1'][0]:.1f} ms "
          f"included); seg {seg_ms:.2f} ms, track {track_ms:.2f} ms per "
          f"volume")
    if bad:
        raise AssertionError(f"bench scene: off JAX's record: {bad}")
    return launches, (pattern, centers)


def wgmma_count(n_vols):
    """``conv3x3x3_wgmma`` launches for ``n_vols`` volumes of the
    backbone: one per tensor-core layer, every layer one launch."""
    from t3dct_torch.ops.hopper_conv import route
    return n_vols * sum(n for *_, ci, co, n in CONV_LAYERS
                        if route(ci, co) == "wgmma")


def f16_steps(a, b):
    """How many float16 steps apart two maps of float16 values (stored as
    float32, non-negative) are, at most."""
    bits = [np.asarray(x, np.float16).view(np.int16).astype(np.int32)
            for x in (a, b)]
    return int(np.abs(bits[0] - bits[1]).max())


def phase_bench_disk(dev, smi, root, pattern, centers):
    """Phase 12: ``segment_and_track(handoff="disk")`` over phase 11's
    TIFFs into a fresh results tree: ``predict_and_save`` on its own
    thread and CUDA stream, ``track_timelapse`` on this one.  Held to
    ``jax_record.npz`` with phase 11's bounds, and its ``seg/`` to phase
    11's: coordinates exact, prob maps within one float16 step."""
    import shutil
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track
    from t3dct_torch.io.artifacts import ResultsTree
    from t3dct_torch.utils.timing import CudaStageTimer
    record = np.load(ASSETS / "jax_record.npz")
    results = root / "results_disk"
    shutil.copytree(root / "results" / "manual_vol1",
                    results / "manual_vol1")
    cands = []
    model = trained_model(dev, cands)
    timer = CudaStageTimer()
    coords, launches = counted(lambda: segment_and_track(
        pattern, model, results, str(results / "manual_vol1" / "*.tif"),
        ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS),
        TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        timer=timer, handoff="disk", device=dev))
    print(f"[bench_disk] launches {launches}")
    check_conv_launches("bench_disk", launches, BENCH_VOLS, stem_count(
        [(ci, co, n) for *_, ci, co, n in CONV_LAYERS]))
    if launches["conv3x3x3_wgmma"] != wgmma_count(BENCH_VOLS):
        raise AssertionError(f"bench_disk: {launches['conv3x3x3_wgmma']} "
                             f"wgmma launches, want "
                             f"{wgmma_count(BENCH_VOLS)}")
    check_flood_launches("bench_disk", launches, BENCH_VOLS - 1)
    bad, _, _ = hold_to_record("bench_disk", record, results, coords,
                               centers, cands, model)
    mine, dev_tree = ResultsTree(results), ResultsTree(root / "results")
    steps = []
    for t in range(1, BENCH_VOLS + 1):
        if not np.array_equal(mine.load_seg_coords(t),
                              dev_tree.load_seg_coords(t)):
            bad.append(f"t={t} seg coords off phase 11's")
        steps.append(f16_steps(mine.load_seg_prob(t),
                               dev_tree.load_seg_prob(t)))
    print(f"[bench_disk] seg/ against phase 11's: coordinates "
          f"{'equal' if not any('seg coords' in b for b in bad) else 'DIFFER'}"
          f", prob maps at most {max(steps)} float16 steps apart")
    # the two handoffs' tracked artifacts, side by side (reported)
    from t3dct_torch.io.imageio import imread_stack
    off, same = [], []
    for t in range(1, BENCH_VOLS + 1):
        off.append(float(np.abs(mine.load_coords_real(t)
                                - dev_tree.load_coords_real(t)).max()))
        pat = "track_results_t%06i_z*.tif" % t
        a, b = (imread_stack(sorted(tr.labels_dir.glob(pat)))
                for tr in (mine, dev_tree))
        same.append(float((a == b).mean()))
    print(f"[bench_disk] track_results/ against phase 11's (handoff="
          f"\"device\"): coords_real max difference {max(off):.3e} real "
          f"units ({sum(o > 0 for o in off)} of {BENCH_VOLS} volumes not "
          f"bit-equal), labels equal {min(same):.6f} at least")
    if max(steps) > 1:
        bad.append(f"prob maps {max(steps)} float16 steps off phase 11's")
    wall = timer.times["call"][0] / BENCH_VOLS
    print(f"[bench_disk] {smi}: wall {wall:.2f} ms per volume for the whole "
          f"call (segmenter thread and tracker at once; host I/O and vol-1 "
          f"interpolation {timer.times['interpolate_vol1'][0]:.1f} ms "
          f"included); track {np.mean(timer.times['track']):.2f} ms per "
          f"tracked volume on the tracker's stream")
    if bad:
        raise AssertionError(f"bench_disk: {bad}")
    return launches


ENSEMBLE = dict(beta=3.0, lambda_=3.0, ensemble=True, sampling_number=20,
                adjacent=False)


def phase_bench_ensemble(dev, smi, root, pattern, centers):
    """Phase 13: the second step of the workflow in ensemble mode,
    ``track_timelapse`` over phase 12's ``seg/`` in a fresh results tree,
    held to ``jax_record_ensemble.npz`` with phase 11's bounds and the
    record's members per volume; then ``TrackerLite.activities`` over its
    labels and ``export_activities_csv``, printed beside the record's."""
    import shutil
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.coordinates import Coordinates
    from t3dct_torch.engine import pipeline
    from t3dct_torch.engine.tracker import TrackerLite
    from t3dct_torch.io.artifacts import ResultsTree
    from t3dct_torch.utils.timing import CudaStageTimer
    record = np.load(ASSETS / "jax_record_ensemble.npz")
    results = root / "results_ensemble"
    for sub in ("seg", "manual_vol1"):
        shutil.copytree(root / ("results_disk" if sub == "seg"
                                else "results") / sub, results / sub)
    # what the run used: each volume's reference list and member batch
    members, batch = {}, []
    volumes_list = pipeline.get_volumes_list
    fan_out = pipeline.ensemble_member_predictions

    def listed(t2, *args, **kwargs):
        members[t2] = volumes_list(t2, *args, **kwargs)
        return members[t2]

    def counted_members(params, state, confirmed, *args, **kwargs):
        batch.append(int(confirmed.shape[0]))
        return fan_out(params, state, confirmed, *args, **kwargs)

    pipeline.get_volumes_list = listed
    pipeline.ensemble_member_predictions = counted_members
    timer = CudaStageTimer()
    try:
        t0 = time.perf_counter()
        coords, launches = counted(lambda: pipeline.track_timelapse(
            results, str(results / "manual_vol1" / "*.tif"),
            ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS), grid=GRID,
            config=TrackingConfig(**ENSEMBLE), verbose=False, timer=timer,
            device=dev))
        wall = 1e3 * (time.perf_counter() - t0) / BENCH_VOLS
        WALLS["bench_ensemble"] = wall
    finally:
        pipeline.get_volumes_list = volumes_list
        pipeline.ensemble_member_predictions = fan_out
    print(f"[bench_ensemble] launches {launches}")
    if launches["conv3x3x3_direct"] or launches["conv3x3x3_wgmma"]:
        raise AssertionError(f"bench_ensemble ran a conv: {launches}")
    check_flood_launches("bench_ensemble", launches, BENCH_VOLS - 1)
    bad, _, _ = hold_to_record("bench_ensemble", record, results, coords,
                               centers, None, None)
    want = {t: record[f"members_{t}"].tolist()
            for t in range(2, BENCH_VOLS + 1)}
    if members != want or batch != [len(want[t]) for t in sorted(want)]:
        bad.append(f"members {members} / batches {batch}, record {want}")
    track = timer.times["track"]
    print(f"[bench_ensemble] {smi}: wall {wall:.2f} ms per volume for the "
          f"call (host I/O and vol-1 interpolation "
          f"{timer.times['interpolate_vol1'][0]:.1f} ms included); ensemble "
          f"track {np.mean(track):.2f} ms per volume; per volume (members, "
          f"ms): {[(n, round(ms, 2)) for n, ms in zip(batch, track)]}")
    vol1 = Coordinates.from_real(coords[1], 10, VOXEL_SIZE, device=dev)
    t0 = time.perf_counter()
    acts = TrackerLite(results, ASSETS / "ffn.npz", vol1).activities(
        pattern, discard_ratio=json.loads(str(record["recipe"]))[
            "discard_ratio"])
    csv = ResultsTree(results).export_activities_csv(acts)
    act_ms = 1e3 * (time.perf_counter() - t0)
    ref = record["activities"]
    diff = np.abs(acts - ref)
    rel = diff / np.maximum(np.abs(ref), 1e-12)
    print(f"[bench_ensemble] activities {acts.shape} in {act_ms:.1f} ms "
          f"({csv.name}, {csv.stat().st_size} bytes): off the record's by "
          f"max {diff.max():.3e} (relative {rel.max():.3e}), median "
          f"{np.median(diff):.3e}; {int((rel > 1e-3).sum())} of {rel.size} "
          f"beyond 1e-3 relative")
    if acts.shape != ref.shape or not np.isfinite(acts).all():
        bad.append(f"activities {acts.shape}")
    if bad:
        raise AssertionError(f"bench_ensemble: {bad}")
    return launches


# the ladder's kernels: (probe entry, wrapper name, file:line of the TPU
# kernel they replace)
LADDER = [("pallas_A_passthrough", "ladder_add_one",
           "scripts/probe_conv_fast.py:126"),
          ("pallas_B_dotgeneral", "ladder_pointwise_matmul",
           "scripts/probe_conv_fast.py:145"),
          ("pallas_C_9view_conv", "ladder_conv9view_bias_relu",
           "scripts/probe_conv_fast.py:187")]


# phase 14: the trainers on the card (bench.py's recipe, :63-73, :214-262)
TRAIN_ASSETS = ROOT / "3deecelltracker_tpu_torch" / "assets" / "train"
TRAIN_BATCH = 2
# the conv Function's gradients against autograd through the plain
# version, relative in the norm (three TF32 passes on both convs, cuDNN
# f32 for dW)
GRAD_RTOL = 1e-4
# JAX's 30-step loss records, relative: each of steps 1-5 within
# LOSS_FIRST_TOL, each later step within LOSS_LATER_TOL; the FFN's every
# step.  The StarDist recipe is chaotic: its first Adam steps move every
# weight by the sign of its gradient, so an ulp decides the sign of the
# smallest ones, and JAX's own runs from its init nudged by one ulp
# (``sd_losses_ulp``, every weight up; ``sd_losses_nudged``, a seeded
# random sign each) part from the record at step 2 (its loss spike) by
# more than LOSS_FIRST_TOL, and by up to tens of percent past step 16.
# So a StarDist step's bound is at least LOSS_SPREAD_FACTOR times the
# largest of the nudged runs' departures there, per step through
# LOSS_PER_STEP; past that horizon the runs are different draws of one
# training, and the steps after it are held by their mean within
# LOSS_SPREAD_FACTOR times the largest of the nudged runs' (a sanity
# bound: a trainer with a fault in its backward can train as far in 30
# steps, and the per-step horizon is what rejects PLANTED).  LOSS_PART:
# the size of a difference reported as the first parting
LOSS_FIRST, LOSS_FIRST_TOL, LOSS_LATER_TOL = 5, 1e-4, 1e-2
LOSS_PER_STEP, LOSS_SPREAD_FACTOR = 16, 2.0
# faults planted in the conv Function's backward, which the record check
# must reject: (name, the gradient zeroed (0 dX, 1 dW, 2 db), only in the
# layers of this c_in or, with None, in every 3x3x3 layer)
PLANTED = (("dW zeroed", 1, None), ("dX zeroed", 0, None),
           ("db zeroed", 2, None), ("the stem's dW zeroed", 1, 1))
LOSS_PART = 1e-5
SD_EPOCHS, SD_STEPS, FFN_ITERS = 16, 30, 600
# the card-trained model on the bench scene: the t = 1 bar of
# bench.py:645-650, GT cells matched at IoU 0.5 at t = 1 (JAX's trained
# model: 150), strict recall and identity switches
MIN_MATCHED, MIN_RECALL, MAX_SWITCHES = 145, 0.95, 3


def train_recipe():
    """(StarDistConfig, trainer kwargs, FFN seed, steps) of the record."""
    from t3dct_torch.config import StarDistConfig
    with np.load(TRAIN_ASSETS / "jax_train_record.npz") as rec:
        recipe = json.loads(str(rec["recipe"]))
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in recipe["sd_config"].items()}
    return (StarDistConfig(**cfg), recipe["sd_trainer"], recipe["ffn_seed"],
            recipe["steps"])


def jax_init_trainer(trainer):
    """``trainer`` (a ``TrainStarDist3D``) started from JAX's initial
    parameters of the recipe."""
    from t3dct_torch.utils.convert import load_npz
    trainer.start_from(load_npz(TRAIN_ASSETS / "sd_init.npz"))
    return trainer


def train_conv_layers(cfg):
    """Every 3x3x3 layer of ``cfg``'s network at the recipe's patch batch
    after the grid pool: {(b, z, y, x, c_in, c_out): count}."""
    from t3dct_torch.models.stardist3d import StarDist3DNet
    base = tuple(p // g for p, g in zip(cfg.train_patch_size, cfg.grid))
    depth = cfg.unet_n_depth
    layers = {}
    for name, ci, co, k in StarDist3DNet(cfg).conv_plan():
        if tuple(k) != (3, 3, 3):
            continue
        level = 0
        if name.startswith(("down", "up")):
            level = int(name.lstrip("downup")[0])
        elif name.startswith("bottom"):
            level = depth
        shape = (TRAIN_BATCH,) + tuple(s // p ** level for s, p in
                                       zip(base, cfg.unet_pool))
        key = shape + (ci, co)
        layers[key] = layers.get(key, 0) + 1
    return layers


def phase_train_grads(dev, layers, relu=True, tag="train grad"):
    """Part 1 of phase 14 (and of phase 20): the conv Function's dX, dW and
    db against autograd through the plain version in float64 (under the
    Function's own ReLU mask, with ``relu``) at every layer shape of
    ``layers`` ({(b, z, y, x, c_in, c_out): count}, a training step's
    3x3x3 layers; the c_in = 1 stem without dX: its input is the image),
    within ``GRAD_RTOL`` in the norm; per layer the forward's kernel time,
    dX's kernel time (with the flipped weights' packing) and cuDNN's for
    the same conv, dW's library time, each with its bound.  Returns the
    sums per training step."""
    import torch
    from t3dct_torch.models.layers import glorot_uniform
    from t3dct_torch.ops import hopper_conv as hc
    from t3dct_torch.utils.roofline import (bound, conv_bound, conv_flop,
                                            conv_tc_bound, library_conv,
                                            nbytes)
    gen = torch.Generator().manual_seed(14)
    sums, worst = {}, 0.0

    def add(key, v, n):
        sums[key] = sums.get(key, 0.0) + n * v

    def own_bound(xin, w, b):
        if hc.route(xin.shape[-1], w.shape[-1]) == "wgmma":
            return conv_tc_bound(xin, w, b)[0]
        return conv_bound(xin, w, b)[0]

    for (*shape, ci, co), n in layers.items():
        xin = torch.relu(torch.randn(tuple(shape) + (ci,), generator=gen)
                         ).to(dev)
        w = glorot_uniform((3, 3, 3, ci, co), 27 * ci, 27 * co, gen, dev)
        b = (torch.randn((co,), generator=gen) * 0.1).to(dev)
        go = torch.randn(tuple(shape) + (co,), generator=gen).to(dev)
        stem = ci == 1
        leaves = [xin.clone().requires_grad_(not stem),
                  w.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)]
        y = hc.Conv3x3x3BiasReLU.apply(*leaves, relu)
        if y.grad_fn is None:
            raise AssertionError("the conv Function's result has no grad_fn")
        got = torch.autograd.grad(y, [t for t in leaves if t.requires_grad],
                                  go)
        # the reference is autograd through the plain version in float64
        # (cuDNN's f64 kernels, not the f32 ones that compute dW) and takes
        # the Function's ReLU mask: where |y| is a few ulp from 0 the
        # kernel's and cuDNN's sums fall on either side, and each such
        # voxel moves a gradient by its whole g
        mask = (y > 0).detach() if relu else torch.ones_like(y, dtype=bool)
        ref = [t.detach().double().requires_grad_(t.requires_grad)
               for t in leaves]
        want = torch.autograd.grad(
            hc.conv3x3x3_bias_relu_plain(*ref, False) * mask,
            [t for t in ref if t.requires_grad], go.double())
        del ref
        flips = int(((hc.conv3x3x3_bias_relu_plain(xin, w, b, True) > 0)
                     != mask).sum()) if relu else 0
        torch.cuda.synchronize()
        errs = [float((a.double() - r).norm() / r.norm().clamp_min(1e-30))
                for a, r in zip(got, want)]
        worst = max(worst, max(errs))
        gm = (go * mask).detach().contiguous()
        wt = hc.flipped_weights(w)
        zeros = torch.zeros(ci, device=dev)
        fwd = cuda_ms(lambda: hc.conv3x3x3_bias_relu(xin, w, b, True), 5, 1)
        row = dict(fwd=fwd, fwd_bound=own_bound(xin, w, b))
        dw = cuda_ms(lambda: hc.conv3x3x3_weight_grad(xin, gm), 5, 1)
        dw_bound = bound(conv_flop(xin, co), nbytes(xin, gm, w))[0]
        row.update(dw=dw, dw_bound=dw_bound)
        if not stem:
            row.update(
                dx=cuda_ms(lambda: hc.conv3x3x3_bias_relu(gm, wt, zeros,
                                                          False), 5, 1),
                dx_flip_pack=cuda_ms(lambda: hc.conv3x3x3_bias_relu(
                    gm, hc.flipped_weights(w), zeros, False, cache=False),
                    5, 1),
                dx_bound=own_bound(gm, wt, zeros),
                dx_library=cuda_ms(lambda: library_conv(gm, wt, zeros), 5,
                                   1),
                dx_plain=cuda_ms(lambda: hc.conv3x3x3_bias_relu_plain(
                    gm, wt, zeros, False), 5, 1))
        for key, v in row.items():
            add(key, v, n)
        print(f"[{tag}] {'x'.join(map(str, shape))} {ci}->{co} x{n}: "
              f"rel err (dX, dW, db / dW, db) "
              f"{', '.join(f'{e:.2e}' for e in errs)} ({flips} of "
              f"{y.numel()} ReLU mask voxels differ from cuDNN's); forward "
              f"{fwd:.4f} ms (least {row['fwd_bound']:.4f}); dX "
              + (f"{row['dx']:.4f} ms, {row['dx_flip_pack']:.4f} with the "
                 f"flip and its packing (least {row['dx_bound']:.4f}, cuDNN "
                 f"{row['dx_library']:.4f}, plain {row['dx_plain']:.4f})"
                 if not stem else "none (the stem)")
              + f"; dW (library) {dw:.4f} ms (least {dw_bound:.4f})")
        if max(errs) > GRAD_RTOL:
            raise AssertionError(f"conv gradient {shape} {ci}->{co}: "
                                 f"{errs} > {GRAD_RTOL}")
    print(f"[{tag}] per step: forward {sums['fwd']:.3f} ms (least "
          f"{sums['fwd_bound']:.3f}), dX {sums['dx']:.3f} ms "
          f"({sums['dx_flip_pack']:.3f} with the flips' packing; least "
          f"{sums['dx_bound']:.3f}, cuDNN {sums['dx_library']:.3f}), dW "
          f"{sums['dw']:.3f} ms (least {sums['dw_bound']:.3f}); worst rel "
          f"err {worst:.2e} (bound {GRAD_RTOL:g})")
    sums["max_rel_err"] = worst
    return sums


def first_parting(got, want, tol):
    """The first step (1-based) whose losses part by more than ``tol``
    relative, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if abs(a - b) > tol * abs(b):
            return i + 1
    return None


def loss_departures(got, want, per_step=None, spread=None):
    """The record check's readings of per-step losses ``got`` against
    JAX's ``want``: the relative difference per step; its bound, within
    ``LOSS_FIRST_TOL`` for steps 1-5 and ``LOSS_LATER_TOL`` after, or
    ``LOSS_SPREAD_FACTOR`` times the largest relative difference of JAX's
    own runs from its init nudged by one ulp (``spread``, runs x steps)
    where that is larger; the steps through ``per_step`` (all by default)
    beyond their bound; and for the steps after them, the relative
    difference of their mean, and its bound, ``LOSS_SPREAD_FACTOR`` times
    the largest of the nudged runs'."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    per_step = len(want) if per_step is None else per_step
    rel = np.abs(got - want) / np.abs(want)
    bound = np.where(np.arange(len(want)) < LOSS_FIRST, LOSS_FIRST_TOL,
                     LOSS_LATER_TOL)
    if spread is not None:
        spread = np.asarray(spread, np.float64)
        bound = np.maximum(bound, LOSS_SPREAD_FACTOR * (
            np.abs(spread - want) / np.abs(want)).max(0))
    out = dict(rel=rel, bound=bound, late=None,
               bad=[i + 1 for i in range(min(per_step, len(got)))
                    if rel[i] > bound[i]])
    if per_step < len(want):
        late = slice(per_step, None)
        mean = want[late].mean()
        out["late"] = (abs(got[late].mean() - mean) / abs(mean),
                       LOSS_SPREAD_FACTOR * float(np.max(
                           np.abs(spread[:, late].mean(1) - mean))
                           / abs(mean)))
    return out


def fmt_rel(v):
    return [float(f"{r:.2e}") for r in v]


def hold_losses(name, got, want, per_step=None, spread=None):
    """:func:`loss_departures`, printed; raises if a step through
    ``per_step`` or the mean of the steps after it is beyond its bound."""
    dep = loss_departures(got, want, per_step, spread)
    print(f"[train record] {name}: {len(got)} steps, rel diff per step "
          f"{fmt_rel(dep['rel'])}; first parting beyond {LOSS_PART:g} at "
          f"step {first_parting(got, want, LOSS_PART)}")
    if spread is not None:
        print(f"[train record] {name}: bound per step through step "
              f"{per_step} {fmt_rel(dep['bound'][:per_step])} (JAX's own "
              f"runs from its init nudged by one ulp: {len(spread)}, their "
              f"largest rel diff times {LOSS_SPREAD_FACTOR:g} where above "
              f"the tolerance)")
    bad = list(dep["bad"])
    if dep["late"] is not None:
        late = slice(per_step, None)
        mean_rel, mean_bound = dep["late"]
        print(f"[train record] {name}: steps {per_step + 1}-{len(want)} "
              f"mean loss card {np.mean(got[late]):.5f}, JAX "
              f"{np.mean(want[late]):.5f} (rel {mean_rel:.2e}, bound "
              f"{mean_bound:.2e}; JAX's nudged runs "
              f"{[round(float(m), 5) for m in np.mean(spread[:, late], 1)]})")
        if mean_rel > mean_bound:
            bad.append(f"mean of steps {per_step + 1}-{len(want)}")
    if len(got) != len(want) or bad:
        raise AssertionError(f"{name}: steps {bad} off JAX's record")


def late_norm_departures(got, want, spread, first=LOSS_PER_STEP):
    """The training record's update-norm statistic.  Per parameter leaf,
    the mean of ``|theta_t - theta_0|`` over steps ``first + 1``.. of
    ``got`` (steps, leaves) against ``want``'s, relative; their root mean
    square over the leaves is the run's departure, bounded by
    ``LOSS_SPREAD_FACTOR`` times the largest departure of JAX's nudged runs
    ``spread`` (runs, steps, leaves), at least ``LOSS_LATER_TOL``.  A leaf
    that does not train is 100% off, and one such leaf of the StarDist
    net's 28 moves the departure by 0.19.  Returns (per-leaf departures,
    the run's departure, its bound)."""
    late = slice(first, None)
    w = np.asarray(want)[late].mean(0)

    def rel(run):
        return np.abs(np.asarray(run)[late].mean(0) - w) / w

    def rms(run):
        return float(np.sqrt(np.mean(rel(run) ** 2)))
    bound = max(LOSS_LATER_TOL,
                LOSS_SPREAD_FACTOR * max(rms(r) for r in spread))
    return rel(got), rms(got), bound


def hold_update_norms(name, got, want, spread, leaves, first=LOSS_PER_STEP):
    """:func:`late_norm_departures`, printed; raises beyond the bound."""
    rel, dep, bound = late_norm_departures(got, want, spread, first)
    print(f"[train record] {name}: update norms |theta_t - theta_0| over "
          f"steps {first + 1}-{len(want)}, mean per leaf: departure (rms "
          f"over {len(rel)} leaves) {dep:.3e}, bound {bound:.3e}; largest "
          f"leaf {leaves[int(rel.argmax())]} {rel.max():.2e}")
    if len(got) != len(want) or dep > bound:
        raise AssertionError(f"{name}: update norms off JAX's record "
                             f"({dep} > {bound})")


def sd_norm_spread(rec):
    """JAX's StarDist runs nudged by one ulp, their update norms: (runs,
    steps, leaves)."""
    return np.concatenate([rec["sd_update_norms_ulp"][None],
                           rec["sd_update_norms_nudged"]])


def sd_spread(rec):
    """JAX's StarDist runs from its init nudged by one ulp, runs x steps:
    every parameter up, then up or down by a seeded random sign."""
    return np.vstack([rec["sd_losses_ulp"][None], rec["sd_losses_nudged"]])


def planted_faults(dev, root, cfg, trainer_kw, img, lab, rec, steps):
    """The record check's power: the same StarDist steps from JAX's init
    with a fault planted in the conv Function's backward (``PLANTED``:
    one of its gradients zeroed, in every 3x3x3 layer or in those with a
    given c_in), each of which the check must reject.  Prints the first
    step beyond its bound and whether the late steps' mean alone rejects
    it.  The Function is restored after each run."""
    import torch
    from t3dct_torch.models import layers
    from t3dct_torch.models.train_stardist import TrainStarDist3D
    from t3dct_torch.ops.hopper_conv import Conv3x3x3BiasReLU
    from t3dct_torch.utils.optim import record_update_norms

    def zeroed(slot, c_in):
        class Faulty(Conv3x3x3BiasReLU):
            @staticmethod
            def backward(ctx, g):
                grads = list(Conv3x3x3BiasReLU.backward(ctx, g))
                if grads[slot] is not None and (
                        c_in is None or ctx.saved_tensors[1].shape[3] == c_in):
                    grads[slot] = torch.zeros_like(grads[slot])
                return tuple(grads)
        return Faulty

    for i, (name, slot, c_in) in enumerate(PLANTED):
        layers.Conv3x3x3BiasReLU = zeroed(slot, c_in)
        try:
            tr = jax_init_trainer(TrainStarDist3D(
                cfg, basedir=root / f"sd_fault{i}", device=dev,
                **trainer_kw))
            norms = record_update_norms(tr)
            losses = tr.train([img], [lab], epochs=steps, steps_per_epoch=1,
                              verbose=False)
        finally:
            layers.Conv3x3x3BiasReLU = Conv3x3x3BiasReLU
        dep = loss_departures(losses, rec["sd_losses"], LOSS_PER_STEP,
                              sd_spread(rec))
        mean_rel, mean_bound = dep["late"]
        _, late_dep, late_bound = late_norm_departures(
            norms, rec["sd_update_norms"], sd_norm_spread(rec))
        late_bad = late_dep > late_bound
        print(f"[train record] planted fault, {name}: rel diff per step "
              f"{fmt_rel(dep['rel'])}; steps beyond their bound "
              f"{dep['bad']}; late mean rel {mean_rel:.2e} (bound "
              f"{mean_bound:.2e}: "
              f"{'rejects' if mean_rel > mean_bound else 'passes'} it); "
              f"steps {LOSS_PER_STEP + 1}-{steps} update norms: departure "
              f"{late_dep:.3e} (bound {late_bound:.3e}: "
              f"{'rejects' if late_bad else 'passes'} it)")
        if not dep["bad"] and mean_rel <= mean_bound and not late_bad:
            raise AssertionError(f"the record check passes a trainer with "
                                 f"{name}")
        if slot == 1 and c_in is None and not late_bad:
            raise AssertionError(f"the late steps' update norms pass a "
                                 f"trainer with {name}")


def vol1_training_data():
    """Vol 1 of the bench scene normalized as ``get_trained_model`` does,
    its labels, and the raw volume."""
    from t3dct_torch.io.imageio import percentile_normalize
    from t3dct_torch.utils.synthetic import make_recording
    vols, _, lab1 = make_recording(1, N_CELLS, (Z, Y, X))
    return percentile_normalize(vols[0].astype(np.float32)), lab1, vols[0]


def ffn_cloud_file(path, coords_xyz):
    """A vol-1 cloud in the pipeline frame times the voxel size, as
    ``bench.py``'s ``train_ffn`` writes it for the trainer."""
    np.savetxt(path, coords_xyz.astype(np.float32)
               * np.asarray(VOXEL_SIZE, np.float32))
    return str(path)


def phase_train_records(dev, root, cfg, trainer_kw, ffn_seed, steps):
    """Part 2 of phase 14: the card's first ``steps`` steps of each
    trainer from JAX's initial parameters and seed, against JAX's record;
    the conv's launches in one step's forward and backward."""
    import torch
    from t3dct_torch.models.train_ffn import DataGeneratorFFN, TrainFFN
    from t3dct_torch.models.train_stardist import TrainStarDist3D
    from t3dct_torch.utils.convert import load_npz
    from t3dct_torch.utils.optim import record_update_norms
    rec = np.load(TRAIN_ASSETS / "jax_train_record.npz")
    img, lab, _ = vol1_training_data()
    sd_init = load_npz(TRAIN_ASSETS / "sd_init.npz")
    tr = TrainStarDist3D(cfg, basedir=root / "sd_record", device=dev,
                         **trainer_kw)
    tr.start_from(sd_init)
    norms = record_update_norms(tr)
    losses, launches = counted(lambda: tr.train(
        [img], [lab], epochs=steps, steps_per_epoch=1, verbose=False))
    hold_losses("StarDist", losses, rec["sd_losses"], LOSS_PER_STEP,
                sd_spread(rec))
    hold_update_norms("StarDist", norms, rec["sd_update_norms"],
                      sd_norm_spread(rec),
                      json.loads(str(rec["sd_update_leaves"])))
    planted_faults(dev, root, cfg, trainer_kw, img, lab, rec, steps)
    # one more step, split: the forward's launches, then the backward's
    x, pg, dg = tr.sample_batch([img], [lab])
    loss, fwd = counted(lambda: tr.loss(tr.params, x, pg, dg))
    _, bwd = counted(lambda: torch.autograd.grad(loss,
                                                 tr.optimizer.params))
    per_step = {k: (fwd[k], bwd[k]) for k in ("conv3x3x3_wgmma",
                                              "conv3x3x3_direct")}
    print(f"[train record] conv launches per step (forward, backward dX): "
          f"{per_step}; over the {steps} record steps {launches}")
    for k, (f, b) in per_step.items():
        if launches[k] != steps * (f + b):
            raise AssertionError(f"{k}: {launches[k]} launches in {steps} "
                                 f"steps, want {f} + {b} a step")
    if per_step["conv3x3x3_wgmma"][1] <= 0:
        raise AssertionError("the backward launched no conv kernel")
    with np.load(ASSETS / "jax_record.npz") as bench_rec:
        cloud = ffn_cloud_file(root / "pts.txt", bench_rec["seg_coords_1"])
    ffn_init = load_npz(TRAIN_ASSETS / "ffn_init.npz")
    tf = TrainFFN("ffn", points1_path=cloud, basedir=root / "ffn_record",
                  seed=ffn_seed, device=dev)
    tf.start_from((ffn_init["0"], ffn_init["1"]))
    # the cloud is on the voxel lattice: its kNN ties are decided by the
    # normalization's last bit, so the steps are held on JAX's normalized
    # cloud and the card's own normalization is held to it
    off = float(np.abs(tf.points_t1 - rec["ffn_points_t1"]).max())
    print(f"[train record] FFN: the card's normalized cloud off JAX's by "
          f"max {off:.2e}")
    if off > 1e-6:
        raise AssertionError(f"FFN normalization off JAX's by {off}")
    tf.points_generator = DataGeneratorFFN(rec["ffn_points_t1"],
                                           seed=ffn_seed, device=dev)
    hold_losses("FFN", tf.train(num_epochs=steps, iteration=0,
                                verbose=False), rec["ffn_losses"])
    return per_step


def step_breakdown(dev, root, cfg, trainer_kw, img, lab, n=20, warm=3):
    """ms per StarDist step by stage, each ended by a sync: patches on the
    host and their upload, GT, forward + loss, backward, Adam."""
    import torch
    from t3dct_torch.models.train_stardist import TrainStarDist3D
    from t3dct_torch.utils.convert import load_npz
    tr = jax_init_trainer(TrainStarDist3D(
        cfg, basedir=root / "sd_breakdown", device=dev, **trainer_kw))
    stages = {k: [] for k in ("data", "gt", "forward", "backward", "adam")}
    for i in range(warm + n):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        pairs = [tr._sample_patch([img], [lab]) for _ in range(tr.batch_size)]
        xb = torch.from_numpy(np.stack([np.ascontiguousarray(a)
                                        for a, _ in pairs])).to(dev)
        yb = torch.from_numpy(np.stack([np.ascontiguousarray(b)
                                        for _, b in pairs])).to(dev)
        mark()
        pg, dg = tr.make_gt(yb)
        mark()
        loss = tr.loss(tr.params, xb, pg, dg)
        mark()
        grads = torch.autograd.grad(loss, tr.optimizer.params)
        mark()
        tr.optimizer.step(grads)
        mark()
        if i >= warm:
            for k, a, b in zip(stages, marks, marks[1:]):
                stages[k].append((b - a) * 1e3)
    out = {k: float(np.mean(v)) for k, v in stages.items()}
    out["step"] = sum(out.values())
    return out


def phase_train_recipe(dev, smi, root, pattern, centers, cfg, trainer_kw,
                       ffn_seed, per_step):
    """Part 3 of phase 14: the whole recipe on the card from JAX's inits
    (16 x 30 StarDist steps, 600 FFN iterations on the trained model's
    vol-1 cloud), saved with ``StarDist3D.save`` and ``save_pytree``, then
    ``segment_and_track(handoff="device")`` over phase 11's recording with
    these weights, beside JAX's trained weights' figures.  ``per_step``:
    the conv's launches a step (forward, backward) from part 2.  Returns
    the training's launches (the path ``train``) and its times."""
    import torch
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.metrics import instance_matching
    from t3dct_torch.engine.pipeline import segment_and_track
    from t3dct_torch.engine.stardist import StarDist3D
    from t3dct_torch.io.imageio import transport_encode
    from t3dct_torch.models.train_ffn import TrainFFN
    from t3dct_torch.models.train_stardist import TrainStarDist3D
    from t3dct_torch.utils.convert import load_npz
    img, lab, raw = vol1_training_data()
    parts = step_breakdown(dev, root, cfg, trainer_kw, img, lab)
    print(f"[train] {smi}: ms per StarDist step by stage (mean of 20, "
          f"each synced): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                         parts.items()))
    tr = jax_init_trainer(TrainStarDist3D(
        cfg, basedir=root / "sd_train", device=dev, **trainer_kw))
    t0 = time.perf_counter()
    losses, launches = counted(lambda: tr.train(
        [img], [lab], epochs=SD_EPOCHS, steps_per_epoch=SD_STEPS,
        verbose=False))
    sd_s = time.perf_counter() - t0
    n_steps = SD_EPOCHS * SD_STEPS
    print(f"[train] StarDist {SD_EPOCHS} x {SD_STEPS} steps: {sd_s:.2f} s, "
          f"{sd_s / n_steps * 1e3:.2f} ms per step (data, GT, forward, "
          f"backward, Adam; save included); epoch losses "
          f"{[round(v, 4) for v in losses]}; launches {launches}")
    model = StarDist3D.load(root / "sd_train" / "stardist", device=dev)
    model.max_candidates, model.render_box = 256, (9, 33, 33)
    jax_model = StarDist3D.load(ASSETS / "sd_model", device=dev)
    jax_model.max_candidates, jax_model.render_box = 256, (9, 33, 33)
    x, mi, ma = transport_encode(raw, "u16")
    matched = {}
    for name, m in (("card", model), ("JAX", jax_model)):
        with torch.no_grad():
            kept, probs, _, points, _, labels = m.predict_instances_device(
                torch.from_numpy(x.astype(np.int32)).to(dev), (mi, ma))
        res = instance_matching(lab, labels.cpu().numpy())
        matched[name] = (int(kept.sum()), res)
        print(f"[train] {name}-trained model at t = 1: {int(kept.sum())} "
              f"cells kept, {res['tp']} of {int(lab.max())} GT cells "
              f"matched at IoU 0.5 (precision {res['precision']:.4f}, "
              f"recall {res['recall']:.4f}, mean IoU "
              f"{res['mean_matched_iou']:.4f})")
    # the FFN on the card-trained model's vol-1 cloud, as bench.py trains
    # its FFN on its trained model's seg/coords000001.npy
    (labels_t1, details), _ = model.finalize_instances(
        [a.cpu().numpy() if a is not None else None for a in
         model.predict_instances_device(torch.from_numpy(
             x.astype(np.int32)).to(dev), (mi, ma), return_labels=False)])
    cloud = ffn_cloud_file(root / "train_pts.txt",
                           details["points"][:, [1, 2, 0]])
    ffn_init = load_npz(TRAIN_ASSETS / "ffn_init.npz")
    tf = TrainFFN("ffn", points1_path=cloud, basedir=root / "ffn_train",
                  seed=ffn_seed, device=dev)
    tf.start_from((ffn_init["0"], ffn_init["1"]))
    t0 = time.perf_counter()
    ffn_loss = tf.train(num_epochs=1, iteration=FFN_ITERS, verbose=False)
    ffn_s = time.perf_counter() - t0
    print(f"[train] FFN {FFN_ITERS + 1} iterations: {ffn_s:.2f} s, "
          f"{ffn_s / (FFN_ITERS + 1) * 1e3:.2f} ms per iteration "
          f"(synthesis, features, step; per-epoch save included); loss "
          f"{ffn_loss[0]:.4f}")
    results = root / "results_trained"
    coords, run_launches = counted(lambda: segment_and_track(
        pattern, model, results, str(root / "results" / "manual_vol1" /
                                     "*.tif"),
        root / "ffn_train" / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS),
        TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        handoff="device", device=dev))
    from t3dct_torch.engine.metrics import tracking_id_metrics
    got = tracking_id_metrics(coords, centers, VOXEL_SIZE, BENCH_VOLS)
    want = json.loads(str(np.load(ASSETS / "jax_record.npz")["metrics"]))
    n1 = np.load(results / "seg" / "coords000001.npy").shape[0]
    print(f"[train] card-trained weights through segment_and_track: "
          f"{n1} cells at t = 1; strict recall {got['strict_recall']}, "
          f"accuracy over every t {got['strict_accuracy_all_t']}, identity "
          f"switches {got['id_switches']} (JAX-trained weights, its "
          f"record: {want}); launches {run_launches}")
    bad = []
    if n1 < N_CELLS // 2:
        bad.append(f"{n1} cells at t = 1 (bench.py's bar {N_CELLS // 2})")
    if matched["card"][1]["tp"] < MIN_MATCHED:
        bad.append(f"{matched['card'][1]['tp']} GT cells matched")
    if got["strict_recall"] < MIN_RECALL:
        bad.append(f"strict recall {got['strict_recall']}")
    if got["id_switches"] > MAX_SWITCHES:
        bad.append(f"{got['id_switches']} identity switches")
    if bad:
        raise AssertionError(f"card-trained model: {bad}")
    for k, (f, b) in per_step.items():
        if launches[k] != n_steps * (f + b):
            raise AssertionError(f"training launches {launches}, want "
                                 f"{f} + {b} of {k} a step")
    return launches, dict(sd_step_ms=sd_s / n_steps * 1e3,
                          ffn_iter_ms=ffn_s / (FFN_ITERS + 1) * 1e3,
                          **{f"step_{k}_ms": v for k, v in parts.items()})


# phase 16: the bench scene through the tiled recording driver, held to
# JAX's record of the same tiled run; y (401) is cut into tiles of 256
# with the bench network's receptive-field shrink (57 -> 64), z and x whole
TILED_RECORD = ASSETS / "jax_record_tiled.npz"
BENCH_TILE = (None, 256, None)
BENCH_RF_Y = 57
# phase 17: examples/segment_large_volume.py's volume, config and tiles;
# with its receptive field (25, 51, 51) the default shrink is 56, so tiles
# of 192 have 80-voxel centres: 7 x 7 tiles
ZEBRAFISH = (64, 512, 512)
ZEBRAFISH_TILE = (None, 192, 192)
# the tiled centres against the whole-volume pass (JAX's own test's bound,
# tests/test_stardist_tiled.py:39-64)
TILED_INTERIOR_ATOL = 1e-6


def tile_batches(model, shape, tile_shape, tile_batch=8, shrink=None):
    """Backbone calls of one tiled sweep of a ``shape`` volume."""
    n = len(model.plan_tiling(shape, tile_shape, shrink).origins)
    return -(-n // max(1, min(tile_batch, n)))


def backbone_layers(model, batch, grid_shape):
    """``(name, input shape, c_out)`` of every 3x3x3 layer of ``model``'s
    backbone on a ``batch`` of volumes whose grid-resolution shape is
    ``grid_shape``: level l of the U-Net runs on it pooled l times (the
    bottom / middle at ``unet_n_depth``); the Keras arch's pre-grid block
    ``pre{s}_i`` runs on the full-resolution volume after its first s grid
    pools."""
    cfg = model.config
    depth, pool = cfg.unet_n_depth, cfg.unet_pool
    pre = []
    if model.arch == "keras":
        shape = [g * s for g, s in zip(grid_shape, cfg.grid)]
        for p in model.net._keras_pools():
            pre.append(tuple(shape))
            shape = [a // b for a, b in zip(shape, p)]
    out = []
    for name, ci, co, kernel in model.net.conv_plan():
        if tuple(kernel) != (3, 3, 3):
            continue
        if name.startswith("pre"):
            out.append((name, (batch,) + pre[int(name[3:].split("_")[0])]
                        + (ci,), co))
            continue
        if name.startswith("down"):
            level = int(name[4:].split("_")[0])
        elif name.startswith("up"):
            level = int(name[2:].split("_")[0])
        else:
            level = depth if name.startswith(("bottom", "middle")) else 0
        shape = tuple(g // p ** level for g, p in zip(grid_shape, pool))
        out.append((name, (batch,) + shape + (ci,), co))
    return out


def backbone_bound(model, batch, grid_shape):
    """The three-pass TF32 bound (ms) of ``backbone_layers``."""
    import torch
    from t3dct_torch.utils.roofline import conv_tc_bound
    meta = dict(device="meta", dtype=torch.float32)
    return sum(conv_tc_bound(torch.empty(shape, **meta),
                             torch.empty((3, 3, 3, shape[-1], co), **meta),
                             torch.empty((co,), **meta))[0]
               for _, shape, co in backbone_layers(model, batch, grid_shape))


def check_backbone_convs(tag, dev, model, batch, grid_shape, errs):
    """Every 3x3x3 layer of ``backbone_layers`` through the router with
    ``model``'s own weights on a seeded ReLU'd input, against the plain
    version within ``CONV_RTOL`` / ``CONV_ATOL``; raises on a miss and
    keeps each kernel's largest error in ``errs``.  These launches are no
    path's: call it outside ``counted``."""
    import torch
    gen = torch.Generator().manual_seed(0)
    worst = {}
    for name, shape, co in backbone_layers(model, batch, grid_shape):
        xin = torch.relu(torch.randn(shape, generator=gen)).to(dev)
        p = model.params[name]
        kernel, err, tol = conv_err(xin, p["w"], p["b"], True)
        del xin
        if not err <= tol:
            raise AssertionError(f"{tag} conv {name} {shape} -> {co}: "
                                 f"{kernel} error {err} > {tol}")
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        worst[kernel] = max(worst.get(kernel, (0.0, 0.0)), (err, tol))
    print(f"[{tag}] conv against the plain version, every 3x3x3 layer of "
          f"the backbone on {batch} x {tuple(grid_shape)}: " + ", ".join(
              f"{k} max_abs_err {e:.3e} (its tol {t:.3e})"
              for k, (e, t) in sorted(worst.items())))


def phase_volume_api(dev, smi, pattern):
    """Phase 15: the reference's per-volume API with the trained weights on
    vol 1 of phase 11's recording: ``predict_instances`` (sparse, dense,
    ``return_predict``) against ``predict_instances_device`` +
    ``finalize_instances`` on the same normalized volume (kept points,
    probs and labels exactly), and ``predict`` against ``forward_grid``'s
    crop (exactly)."""
    import warnings
    import torch
    from t3dct_torch.engine.stardist import StarDist3D
    from t3dct_torch.io.imageio import (load_2d_slices_at_time,
                                        transport_encode)
    from t3dct_torch.io.prefetch import to_host
    from t3dct_torch.utils.device import upload_raw
    model = StarDist3D.load(ASSETS / "sd_model", device=dev)
    model.max_candidates, model.render_box = 256, (9, 33, 33)
    raw, mi, ma = transport_encode(
        load_2d_slices_at_time(pattern, 1, do_normalize=False), "u16")
    x_raw = upload_raw(raw, dev)
    want_inst, want_prob = model.finalize_instances(to_host(
        model.predict_instances_device(x_raw, (mi, ma), True), None, None))
    mi_t, ma_t = (torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in (mi, ma))
    x = (x_raw.to(torch.float32) - mi_t) / (ma_t - mi_t + 1e-20)

    def run():
        sparse = model.predict_instances(x)
        dense = model.predict_instances(x, sparse=False)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            full = model.predict_instances(x, return_predict=True)
        prob, dist = model.predict(x)
        return sparse, dense, full, (prob, dist), caught

    t0 = time.perf_counter()
    (sparse, dense, full, (prob, dist), caught), launches = counted(run)
    wall = time.perf_counter() - t0
    bad = []
    (w_lab, w_det) = want_inst
    for name, (lab, det) in (("sparse", sparse[0]), ("dense", dense[0]),
                             ("return_predict", full[0])):
        for key in ("points", "prob"):
            if not np.array_equal(det[key], w_det[key]):
                bad.append(f"{name} {key}")
        if not np.array_equal(lab, w_lab):
            bad.append(f"{name} labels")
    if not np.array_equal(sparse[1], want_prob):
        bad.append("sparse prob map")
    prob_g, dist_g = model.forward_grid(x)
    gz, gy, gx = (-(-s // g) for s, g in zip(raw.shape, model.config.grid))
    if prob.shape != (gz, gy, gx) or dist.shape != (gz, gy, gx,
                                                    model.config.n_rays):
        bad.append(f"predict shapes {prob.shape} {dist.shape}")
    elif not (np.array_equal(prob, prob_g[:gz, :gy, :gx].cpu().numpy())
              and np.array_equal(dist,
                                 dist_g[:gz, :gy, :gx].cpu().numpy())):
        bad.append("predict against forward_grid")
    if not (np.array_equal(dense[1], prob) and full[1][0] is full[2]
            and np.array_equal(full[2], prob)):
        bad.append("dense prob maps")
    if not any("Setting sparse to False" in str(w.message) for w in caught):
        bad.append("return_predict's warning")
    print(f"[api] {smi}: predict_instances (sparse, dense, return_predict) "
          f"and predict on vol 1 {raw.shape}: {len(w_det['points'])} cells "
          f"kept as by predict_instances_device; predict {prob.shape} "
          f"{dist.shape}; {wall:.2f} s for the four calls; launches "
          f"{launches}")
    if bad:
        raise AssertionError(f"per-volume API: {bad}")
    # backbone passes: sparse 1, dense and return_predict 2 each, predict 1
    check_conv_launches("api", launches, 6, stem_count(
        [(ci, co, n) for *_, ci, co, n in CONV_LAYERS]))
    return launches


def phase_tiled_bench(dev, smi, root, pattern, centers):
    """Phase 16: ``predict_and_save(tile_shape=BENCH_TILE)`` over phase
    11's 21 TIFF volumes with the trained weights, then ``track_timelapse``
    in single mode, held to ``jax_record_tiled.npz`` with phase 11's
    bounds (kept cells by ``kept_difference``, the first volume's labels
    at ``LABELS_EQUAL``, tracked coordinates, strict recall and switches
    equal).  The kept cells farther than the receptive field from the y
    faces must all be phase 11's whole-volume ones.  Times one batched
    backbone call over the scene's tiles beside its bound and the
    whole-volume backbone, and holds every conv layer at the sweep's tile
    batch against the plain version.  Returns the launches, the times and
    each conv kernel's largest error there."""
    import shutil
    import torch
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import track_timelapse
    from t3dct_torch.engine.stardist import predict_and_save
    from t3dct_torch.io.artifacts import ResultsTree
    from t3dct_torch.io.imageio import imread_stack
    from t3dct_torch.ops.tiling import pad_for_tiles
    from t3dct_torch.utils.timing import CudaStageTimer
    record = np.load(TILED_RECORD)
    recipe = json.loads(str(record["recipe"]))
    results = root / "results_tiled"
    shutil.copytree(root / "results" / "manual_vol1",
                    results / "manual_vol1")
    cands = []
    model = trained_model(dev, cands, "predict_instances_tiled_device")
    timer = CudaStageTimer()
    walls = {}

    def run():
        t0 = time.perf_counter()
        predict_and_save(pattern, model, results,
                         tile_shape=tuple(recipe["tile_shape"]),
                         tile_candidates=recipe["tile_candidates"],
                         tile_batch=recipe["tile_batch"],
                         shrink=recipe["shrink"])
        torch.cuda.synchronize()
        walls["seg"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        coords = track_timelapse(
            results, str(results / "manual_vol1" / "*.tif"),
            ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS), grid=GRID,
            config=TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
            timer=timer, device=dev)
        walls["track"] = time.perf_counter() - t0
        return coords

    coords, launches = counted(run)
    batches = tile_batches(model, (Z, Y, X), BENCH_TILE,
                           recipe["tile_batch"])
    print(f"[tiled] launches {launches}; {batches} tile batch(es) of "
          f"{len(model.plan_tiling((Z, Y, X), BENCH_TILE).origins)} tiles "
          f"per volume")
    check_conv_launches("tiled", launches, BENCH_VOLS * batches, stem_count(
        [(ci, co, n) for *_, ci, co, n in CONV_LAYERS]))
    if launches["conv3x3x3_wgmma"] != wgmma_count(BENCH_VOLS * batches):
        raise AssertionError(f"tiled: {launches['conv3x3x3_wgmma']} wgmma "
                             f"launches, want "
                             f"{wgmma_count(BENCH_VOLS * batches)}")
    check_flood_launches("tiled", launches, BENCH_VOLS - 1)
    bad, _, _ = hold_to_record("tiled", record, results, coords, centers,
                               cands, model)
    lab1 = imread_stack(sorted((results / "auto_vol1").glob("*.tif"))
                        ).transpose(1, 2, 0)
    same = float((lab1 == record["auto_vol1"]).mean())
    print(f"[tiled] first volume's auto_vol1 labels equal JAX's tiled "
          f"record's: {same:.5f}")
    if lab1.dtype != record["auto_vol1"].dtype or same < LABELS_EQUAL:
        bad.append(f"auto_vol1 labels {same}")
    # beyond the receptive field of the y faces, the tiled cells are the
    # whole-volume ones (phase 11's seg/)
    mine, whole = ResultsTree(results), ResultsTree(root / "results")
    n_same = n_all = 0
    for t in range(1, BENCH_VOLS + 1):
        a, b = ({tuple(p) for p in tree.load_seg_coords(t)
                 if BENCH_RF_Y < p[0] < Y - 1 - BENCH_RF_Y}
                for tree in (mine, whole))
        n_same += len(a & b)
        n_all += len(a | b)
    share = n_same / max(n_all, 1)
    print(f"[tiled] kept cells more than {BENCH_RF_Y} voxels from the y "
          f"faces equal to phase 11's whole-volume seg/: {n_same} of "
          f"{n_all} ({100 * share:.2f}%)")
    if share != 1.0:
        bad.append(f"interior cells {n_same}/{n_all}")

    # one batched backbone call over vol 1's tiles, its bound, and the
    # whole-volume backbone, on the same volume
    from t3dct_torch.io.imageio import load_2d_slices_at_time
    from t3dct_torch.utils.device import upload_raw
    raw = load_2d_slices_at_time(pattern, 1, do_normalize=False)
    x = upload_raw(raw, dev).to(torch.float32)
    x = (x - x.mean()) / x.std()
    plan = model.plan_tiling((Z, Y, X), BENCH_TILE)
    xp = pad_for_tiles(x, plan)
    tz, ty, tx = plan.tile_shape
    xb = torch.stack([xp[o0:o0 + tz, o1:o1 + ty, o2:o2 + tx]
                      for o0, o1, o2 in plan.origins.tolist()])[..., None]
    with torch.no_grad():
        t_tiles = cuda_ms(lambda: model.net.apply(model.params, xb), 5, 1)
        t_whole = cuda_ms(lambda: model.forward_grid(x), 5, 1)
    grid_tile = tuple(t // g for t, g in zip(plan.tile_shape, GRID))
    bound_tiles = backbone_bound(model, len(plan.origins), grid_tile)
    pads = tuple(-(-s // d) * d for s, d in zip((Z, Y, X), model.net.div_by))
    bound_whole = backbone_bound(model, 1, tuple(
        s // g for s, g in zip(pads, GRID)))
    n_vols = BENCH_VOLS
    print(f"[tiled] {smi}: seg {1e3 * walls['seg'] / n_vols:.2f} ms per "
          f"volume (the whole predict_and_save, TIFF decode and seg/ writes "
          f"included), track {1e3 * walls['track'] / (n_vols - 1):.2f} ms "
          f"per tracked volume (track_timelapse; its track stage "
          f"{np.mean(timer.times['track']):.2f}); conv launches per volume: "
          f"wgmma {launches['conv3x3x3_wgmma'] / n_vols:.0f}, direct "
          f"{launches['conv3x3x3_direct'] / n_vols:.0f}")
    # the conv kernels at the shapes the sweep gave them, against the
    # plain version
    errs = {}
    check_backbone_convs("tiled", dev, model,
                         min(recipe["tile_batch"], len(plan.origins)),
                         grid_tile, errs)
    print(f"[tiled] {smi}: backbone on the {len(plan.origins)} tiles "
          f"{plan.tile_shape} of a volume, one batch: {t_tiles:.3f} ms "
          f"(three-pass TF32 bound {bound_tiles:.3f} ms, "
          f"{bound_tiles / t_tiles:.1%} of it); whole-volume backbone "
          f"{t_whole:.3f} ms (bound {bound_whole:.3f} ms)")
    if bad:
        raise AssertionError(f"tiled bench scene: {bad}")
    return launches, dict(tiled_seg_ms_per_vol=1e3 * walls["seg"] / n_vols,
                          tiled_track_ms_per_vol=1e3 * walls["track"]
                          / (n_vols - 1),
                          tiled_backbone_ms=t_tiles,
                          tiled_backbone_bound_ms=bound_tiles,
                          whole_backbone_ms=t_whole,
                          whole_backbone_bound_ms=bound_whole), errs


def phase_zebrafish(dev, smi):
    """Phase 17: ``examples/segment_large_volume.py``'s config (seeded
    random init) on its (64, 512, 512) ``default_rng(0)`` volume:
    (1) with the receptive-field shrink the tiled prob map equals the
    whole-volume ``forward_grid`` beyond the receptive field of every tiled
    face, within ``TILED_INTERIOR_ATOL``; (2) ``tile_batch=8`` equals
    ``tile_batch=1`` bit for bit (prob map, points, probs, labels), at the
    threshold that keeps the top 1% of the grid inside the candidates'
    border (random weights give no prob near the config's 0.8); (3) the
    example's own settings through ``scripts.segment_large_volume.main``,
    its seconds per volume, launches and peak memory beside the
    whole-volume pass's, and the same sweep timed at (2)'s threshold, so
    that its NMS and render have instances to work on; (4) every conv
    layer at the shapes of the tile batches and of the whole volume
    against the plain version.  Each tiled run's direct conv launches once
    per tile batch.  The launches returned are the tiled runs' alone."""
    import torch
    from t3dct_torch.config import StarDistConfig
    from t3dct_torch.engine.stardist import StarDist3D
    from t3dct_torch.scripts import segment_large_volume as script
    from t3dct_torch.utils.device import upload_raw
    model = StarDist3D(StarDistConfig(**script.CONFIG), max_candidates=512,
                       render_box=(9, 17, 17), device=dev)
    x = np.random.default_rng(0).random(ZEBRAFISH, np.float32)
    total = {}

    def tiled(label, batches, **kw):
        out, launches = counted(lambda: model.predict_instances_tiled(
            x, tile_shape=ZEBRAFISH_TILE, **kw))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if launches["conv3x3x3_wgmma"] <= 0 or \
                launches["conv3x3x3_direct"] != batches:
            raise AssertionError(f"zebrafish {label}: launches {launches}, "
                                 f"want wgmma > 0 and direct == {batches}")
        return out

    n_tiles = len(model.plan_tiling(ZEBRAFISH, ZEBRAFISH_TILE).origins)
    b8 = tiled("tile_batch=8", -(-n_tiles // 8), tile_batch=8)
    # random weights keep every prob below the config's 0.8: the batch
    # check takes the threshold that keeps the top 1% of the grid inside
    # the candidates' border (its faces hold the largest values)
    thr = float(np.quantile(b8[1][2:-2, 2:-2, 2:-2], 0.99))
    c8 = tiled("tile_batch=8", -(-n_tiles // 8), tile_batch=8,
               prob_thresh=thr)
    c1 = tiled("tile_batch=1", n_tiles, tile_batch=1, prob_thresh=thr)
    (whole_prob, _), whole_launches = counted(lambda: model.forward_grid(
        upload_raw(x, dev)))
    gz, gy, gx = (-(-s // g) for s, g in zip(ZEBRAFISH, model.config.grid))
    whole_prob = whole_prob[:gz, :gy, :gx].cpu().numpy()
    m = -(-model.net.receptive_field()[1] // model.config.grid[1])
    diff = np.abs(b8[1][:, m:-m, m:-m] - whole_prob[:, m:-m, m:-m])
    print(f"[zebrafish] {n_tiles} tiles of {ZEBRAFISH_TILE} (receptive "
          f"field {model.net.receptive_field()}): tiled prob map against "
          f"the whole-volume pass beyond {m} grid voxels of the tiled faces: "
          f"max {diff.max():.3e} ({int((diff > 0).sum())} of {diff.size} "
          f"voxels not bit-equal); the whole-volume pass (no tiled run, "
          f"not in the path's launches): wgmma "
          f"{whole_launches['conv3x3x3_wgmma']}, direct "
          f"{whole_launches['conv3x3x3_direct']}")
    bad = []
    if not diff.max() <= TILED_INTERIOR_ATOL:
        bad.append(f"interior prob map {diff.max()}")
    same = (np.array_equal(c8[1], c1[1])
            and np.array_equal(c8[0][1]["points"], c1[0][1]["points"])
            and np.array_equal(c8[0][1]["prob"], c1[0][1]["prob"])
            and np.array_equal(c8[0][0], c1[0][0]))
    n_inst = len(c8[0][1]["points"])
    print(f"[zebrafish] tile_batch=8 against tile_batch=1 at prob_thresh "
          f"{thr:.6f}: prob map, points, probs and labels "
          f"{'bit-equal' if same else 'DIFFER'} ({n_inst} instances; "
          f"{len(b8[0][1]['points'])} at the config's "
          f"{model.thresholds['prob']})")
    if not same or n_inst == 0:
        bad.append(f"tile_batch 8 against 1 ({n_inst} instances)")

    # the example's own settings, through the script
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out, launches = counted(lambda: script.main(["--repeat", "2"]))
    peak_tiled = torch.cuda.max_memory_allocated(dev) - base
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    batches = 2 * tile_batches(model, ZEBRAFISH, ZEBRAFISH_TILE,
                               shrink=script.TILED["shrink"])
    if launches["conv3x3x3_wgmma"] <= 0 or \
            launches["conv3x3x3_direct"] != batches:
        bad.append(f"script launches {launches}, want direct {batches}")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (_, det_whole), _ = model.predict_instances(x)
    peak_whole = torch.cuda.max_memory_allocated(dev) - base
    # the same sweep at (2)'s threshold: instances for its NMS and render
    walls_thr = []

    def sweep_thr():
        for _ in range(2):
            t0 = time.perf_counter()
            res = model.predict_instances_tiled(
                x, tile_shape=ZEBRAFISH_TILE, prob_thresh=thr,
                **script.TILED)
            walls_thr.append(time.perf_counter() - t0)
        return res

    res_thr, launches_thr = counted(sweep_thr)
    for k, v in launches_thr.items():
        total[k] = total.get(k, 0) + v
    if launches_thr["conv3x3x3_direct"] != batches:
        bad.append(f"sweep at {thr} launches {launches_thr}, want direct "
                   f"{batches}")
    n_thr = len(res_thr[0][1]["points"])
    first, warm = out["seconds"]
    print(f"[zebrafish] {smi}: scripts/segment_large_volume.py "
          f"({script.TILED}): {out['instances']} instances (random weights: "
          f"no prob reaches the config's {model.thresholds['prob']}, so "
          f"these seconds hold no NMS or render work), "
          f"{first:.3f} s first call, {warm:.3f} s warm per volume; the "
          f"same sweep at prob_thresh {thr:.6f}: {n_thr} instances, "
          f"{walls_thr[0]:.3f} s, then {walls_thr[1]:.3f} s; conv "
          f"launches per call wgmma {launches['conv3x3x3_wgmma'] // 2}, "
          f"direct {launches['conv3x3x3_direct'] // 2}; peak memory "
          f"{peak_tiled / 2**20:.1f} MiB tiled, {peak_whole / 2**20:.1f} MiB "
          f"the whole-volume instance program ({len(det_whole['points'])} "
          f"instances)")
    if n_thr == 0:
        bad.append(f"no instances at {thr}")
    # the conv kernels at the shapes of (1)-(3)'s tile batches and of the
    # whole-volume pass, against the plain version
    errs = {}
    grid_tile = tuple(t // g for t, g in zip(
        model.plan_tiling(ZEBRAFISH, ZEBRAFISH_TILE).tile_shape,
        model.config.grid))
    for batch in sorted({min(8, n_tiles), 1}):
        check_backbone_convs("zebrafish", dev, model, batch, grid_tile, errs)
    check_backbone_convs("zebrafish", dev, model, 1, tuple(
        -(-s // d) * d // g for s, d, g in zip(
            ZEBRAFISH, model.net.div_by, model.config.grid)), errs)
    if bad:
        raise AssertionError(f"zebrafish: {bad}")
    return total, dict(zebrafish_first_s=first, zebrafish_warm_s=warm,
                       zebrafish_thr_instances=n_thr,
                       zebrafish_thr_first_s=walls_thr[0],
                       zebrafish_thr_warm_s=walls_thr[1],
                       zebrafish_interior_max_abs_err=float(diff.max()),
                       zebrafish_peak_tiled_mib=peak_tiled / 2**20,
                       zebrafish_peak_whole_mib=peak_whole / 2**20), errs


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


# phases 18-21: the legacy v0.4 workflow as examples/use_unet_legacy.py
# runs it, with U-Net a trained by JAX (assets/legacy/), held to JAX's
# records of the same runs (tests/test_torch_legacy_record.py)
LEGACY_ASSETS = ROOT / "3deecelltracker_tpu_torch" / "assets" / "legacy"
LEG_EXAMPLE = dict(z_xy_ratio=9.2, z_scaling=10, noise_level=200.0,
                   min_size=100, beta_tk=300.0, lambda_tk=0.1, maxiter_tk=20)
LEG_IMAGE = "raw_t%04i_z%04i.tif"
LEG_ENSEMBLE = 20
# the bounds on a legacy run against JAX's record, fixed before the card's
# first run of phases 18-19 at twice the departure of the port's CPU run of
# phase 18 from it (tests/test_torch_legacy_record.py::
# test_port_on_cpu_matches_records): one volume's cell count off by one,
# tracked coordinates up to 2.114 real units off by the median of a volume
# (9.826 at most, under the identity gate), labels 99.414% equal, strict
# recall 0.8867 against 0.8533, 18 identity switches against 25.  The
# legacy EM's outlier share gamma = 1 - m_p / m cancels to ~1e-9 once the
# fit explains every target, and its sign, set by rounding, decides whether
# outlier rows leave the fit (gamma > 0, JAX's run) or gamma stays <= 0
# (ROADMAP.md C.9): on JAX's own inputs the two fits part by 0.2-0.7 real
# units (median) in 5 of 8 bench volumes tried, and the tracked cells carry
# that on.  auto_vol1 is held as phase 11's labels (LABELS_EQUAL).
LEG_CELLS_OFF = 2
LEG_COORD_MEDIAN = 4.25
LEG_LABELS_EQUAL = 0.988
LEG_RECALL_OFF = 0.067
LEG_SWITCHES_OFF = 14
# phase 20: U-Net a's training batch (TrainingUNet3D's batch of 8 tiles)
UNET_TRAIN_BATCH = 8
# phase 20's --retrain run: the bench scene's cells hold 66-77 voxels, all
# below the example's min_size of 100, which leaves no cell once the
# retrained net outlines them (the JAX-trained one marks blobs of 100 to
# 15000 voxels)
LEG_RETRAIN_MIN_SIZE = 20


def write_legacy_folder(root, n_vols=BENCH_VOLS):
    """The example's folder for the bench scene: ``data/`` the raw
    (x, y, z) volumes as ``raw_t%04i_z%04i.tif`` slices, ``manual_vol1/``
    the ground truth, ``models/`` the trained U-Net and the bench FFN.
    Returns the folder and the true centres."""
    import shutil
    from t3dct_torch.io.imageio import save_label_slices
    from t3dct_torch.utils.synthetic import make_recording
    vols, centers, lab1 = make_recording(n_vols, N_CELLS, (Z, Y, X))
    for t, v in enumerate(vols, start=1):
        save_label_slices(v.transpose(1, 2, 0), root / "data", LEG_IMAGE, t,
                          use_8_bit=False, compression=None)
    save_label_slices(lab1.transpose(1, 2, 0), root / "manual_vol1",
                      "manual_t%04i_z%04i.tif", 1, use_8_bit=False,
                      compression=None)
    (root / "models").mkdir(parents=True, exist_ok=True)
    shutil.copy(LEGACY_ASSETS / "unet3_a.npz", root / "models")
    shutil.copy(ASSETS / "ffn.npz", root / "models")
    return root, centers


def legacy_tracker(dev, folder, n_vols=BENCH_VOLS, siz=(Y, X, Z), f32=False,
                   **kw):
    """The folder ``Tracker`` with the example's settings; ``f32=True``:
    a subclass whose segmenter computes in float32 (the precision of the
    float32 records), else JAX's default, bfloat16."""
    import torch
    from t3dct_torch.engine.legacy import Tracker

    class Float32Tracker(Tracker):
        def _build_segmenter(self):
            self.segmenter = self._new_segmenter(torch.float32)
    return (Float32Tracker if f32 else Tracker)(
        volume_num=n_vols, siz_xyz=siz, **LEG_EXAMPLE,
        folder_path=str(folder), image_name=LEG_IMAGE,
        unet_model_file="unet3_a.npz", ffn_model_file="ffn.npz",
        max_cells=LEG_MAX_CELLS, device=dev, **kw)


def timed_legacy_example(tracker, timer):
    """The example's flow after proofreading, from an empty U-Net cache,
    each volume's segmentation (stage ``seg``) and tracking (``track``)
    timed."""
    seg, track = tracker._segment_array, tracker._track_volume

    def timed_seg(*args, **kwargs):
        with timer.stage("seg"):
            return seg(*args, **kwargs)

    def timed_track(*args, **kwargs):
        with timer.stage("track"):
            return track(*args, **kwargs)
    tracker._segment_array, tracker._track_volume = timed_seg, timed_track
    with timer.stage("call"):
        tracker.load_unet()
        tracker.set_segmentation(del_cache=True)
        tracker.load_ffn()
        tracker.segment_vol1()
        tracker.load_manual_seg()
        tracker.interpolate_seg()
        tracker.cal_subregions()
        tracker.initiate_tracking()
        tracker.track(from_volume=2)
        tracker.save_coordinates()
    return tracker


def hold_legacy_to_record(path, record, tracker, centers):
    """A legacy run against JAX's record: cells found per volume (at most
    ``LEG_CELLS_OFF`` volumes off, by one), tracked coordinates within
    ``LEG_COORD_MEDIAN`` per volume and every cell within the record's
    identity gate, ``auto_vol1`` ``LABELS_EQUAL`` and the tracked labels
    ``LEG_LABELS_EQUAL`` per volume, strict recall within
    ``LEG_RECALL_OFF`` and identity switches within ``LEG_SWITCHES_OFF``
    of the record's; the GT cells that ``auto_vol1`` matches at IoU 0.5
    printed beside the record's.  Returns what failed and this run's
    metrics."""
    from t3dct_torch.engine.metrics import (instance_matching,
                                            tracking_id_metrics)
    from t3dct_torch.io.imageio import imread_stack
    want = json.loads(str(record["metrics"]))
    h = tracker.history
    cells = np.array([len(c) for c in h.r_segmented_coordinates])
    off = np.abs(cells - record["cells"])
    bad = []
    print(f"[{path}] cells found per volume (card; JAX): {cells.tolist()}; "
          f"{record['cells'].tolist()}")
    if off.max() > 1 or (off > 0).sum() > LEG_CELLS_OFF:
        bad.append(f"cells {cells.tolist()}")

    def labels(folder, name):
        files = sorted(Path(folder).glob(name))
        return imread_stack(files).transpose(1, 2, 0)
    auto = labels(tracker.paths.auto_segmentation_vol1, "auto_R_t0001_z*")
    same = float((auto == record["auto_vol1"]).mean())
    print(f"[{path}] auto_vol1 equal to the record's: {same:.6f}")
    if same < LABELS_EQUAL:
        bad.append("auto_vol1")
    coords = {t: c for t, c in enumerate(h.r_tracked_coordinates, start=1)}
    for t in range(1, BENCH_VOLS + 1):
        d = np.linalg.norm(coords[t] - record[f"coords_{t}"], axis=1)
        lab = labels(tracker.paths.track_results,
                     "track_results_t%06i_z*.tif" % t)
        eq = float((lab == record[f"labels_{t}"]).mean())
        print(f"[{path}] t={t}: coords off JAX's record by median "
              f"{np.median(d):.3e}, max {d.max():.3e} real units (cell "
              f"{int(d.argmax())}), {int((d > 0.5).sum())} beyond 0.5; "
              f"labels equal {eq:.5f}")
        if not np.isfinite(coords[t]).all() or \
                np.median(d) > LEG_COORD_MEDIAN or d.max() > want["gate"]:
            bad.append(f"t={t} coords")
        if eq < LEG_LABELS_EQUAL:
            bad.append(f"t={t} labels")
    got = tracking_id_metrics(coords, centers, VOXEL_SIZE, BENCH_VOLS)
    got["matched_t1"] = instance_matching(
        labels(tracker.paths.manual_segmentation_vol1, "*.tif"), auto,
        0.5)["tp"]
    print(f"[{path}] strict recall {got['strict_recall']}, accuracy over "
          f"every t {got['strict_accuracy_all_t']}, identity switches "
          f"{got['id_switches']}, GT cells matched at IoU 0.5 at t = 1 "
          f"{got['matched_t1']} (JAX's record: {want})")
    bad += [f"{k} {got[k]}" for k, tol in (("strict_recall", LEG_RECALL_OFF),
                                          ("id_switches", LEG_SWITCHES_OFF))
            if abs(got[k] - want[k]) > tol]
    return bad, got


def phase_legacy_folder(dev, smi, folder, centers, ensemble=False):
    """Phase 18 (single mode, path ``legacy_folder``) and 19 (``ensemble=
    20``, path ``legacy_ensemble``, the same folder afterwards): the
    example's flow through the folder ``Tracker`` with the trained U-Net,
    held to ``jax_legacy_record.npz`` / ``jax_legacy_record_ensemble.npz``
    (``hold_legacy_to_record``).  Every counter reset before the run and
    read after: the ``wgmma`` conv, the direct stem (one per volume), the
    flood and cc must each have run.  Prints seg and track ms per volume
    and the wall per volume of the whole call."""
    from t3dct_torch.utils.timing import CudaStageTimer
    path = "legacy_ensemble" if ensemble else "legacy_folder"
    record = np.load(LEGACY_ASSETS / ("jax_legacy_record_ensemble.npz"
                                      if ensemble else
                                      "jax_legacy_record.npz"))
    kw = dict(ensemble=LEG_ENSEMBLE) if ensemble else {}
    timer = CudaStageTimer()
    tracker, launches = counted(lambda: timed_legacy_example(
        legacy_tracker(dev, folder, f32=True, **kw), timer))
    print(f"[{path}] launches {launches}")
    check_conv_launches(path, launches, BENCH_VOLS, stem_count(
        [(ci, co, n) for (*_, ci, co), n
         in unet_conv_layers(tracker.unet_model).items()]))
    check_flood_launches(path, launches, BENCH_VOLS)
    if launches["cc_label"] <= 0:
        raise AssertionError(f"{path}: cc was not launched: {launches}")
    bad, _ = hold_legacy_to_record(path, record, tracker, centers)
    seg, track = timer.times["seg"], timer.times["track"]
    print(f"[{path}] {smi}: wall {timer.times['call'][0] / BENCH_VOLS:.2f} "
          f"ms per volume for the whole call (TIFF reads and writes, cache, "
          f"vol-1 interpolation included); seg {np.mean(seg):.2f} ms per "
          f"volume {[round(v, 1) for v in seg]}; track {np.mean(track):.2f}"
          f" ms per volume {[round(v, 1) for v in track]}")
    if bad:
        raise AssertionError(f"{path}: off JAX's record: {bad}")
    return launches, dict(
        seg_ms=float(np.mean(seg)), track_ms=float(np.mean(track)),
        wall_ms=timer.times["call"][0] / BENCH_VOLS)


def unet_train_layers(spec, batch=UNET_TRAIN_BATCH):
    """Every 3x3x3 layer of ``spec`` on a training batch of ``batch``
    tiles: {(b, x, y, z, c_in, c_out): count}."""
    return {(batch,) + k: n for k, n in unet_conv_layers(spec).items()}


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def replay_unet_record(dev, folder, rec, zero_dw=False, mesh=None):
    """The first steps of ``retrain_unet`` on ``dev`` from the trained
    weights in ``folder`` (``write_legacy_folder``), on JAX's batches: the
    record's affine draws replace the trainer's, and its patch starts must
    be the ones ``np.random.RandomState(1)`` gives here.  ``zero_dw``
    plants every 3x3x3 dW zeroed; ``mesh``: the trainer is
    ``TrainingUNet3D(mesh=mesh)``, its steps
    ``make_sharded_unet_train_step``'s.  Returns the losses, the update
    norms (steps, leaves), ms per step and the trained parameters."""
    import torch
    from t3dct_torch.models import layers as L
    from t3dct_torch.models import train_unet
    from t3dct_torch.ops.hopper_conv import Conv3x3x3BiasReLU
    from t3dct_torch.utils.optim import record_update_norms
    tracker = legacy_tracker(dev, folder)
    tracker.load_unet()
    tracker.load_manual_seg()
    cls = train_unet.TrainingUNet3D
    if mesh is not None:
        train_unet.TrainingUNet3D = functools.partial(cls, mesh=mesh)
    try:
        trainer = tracker._unet_trainer()
    finally:
        train_unet.TrainingUNet3D = cls
    draws = [[(torch.from_numpy(m), torch.from_numpy(o))
              for m, o in zip(ms, offs)]
             for ms, offs in zip(rec["affine_m"], rec["affine_offset"])]
    trainer._draw_affines = lambda b, hw: draws.pop(0)
    norms = record_update_norms(trainer)
    rng_np = np.random.RandomState(1)
    losses, starts, times = [], [], []

    class NoWeightGrad(Conv3x3x3BiasReLU):
        @staticmethod
        def backward(ctx, g):
            dx, dw, db, *rest = Conv3x3x3BiasReLU.backward(ctx, g)
            return (dx, torch.zeros_like(dw), db, *rest)
    if zero_dw:
        L.Conv3x3x3BiasReLU = NoWeightGrad
    try:
        for _ in range(len(rec["losses"])):
            state = rng_np.get_state()
            n = trainer.train_subimage.shape[0]
            starts.append(rng_np.randint(0, max(n - trainer.batch_size, 1)))
            rng_np.set_state(state)
            sync(dev)
            t0 = time.perf_counter()
            loss = trainer.train_step(*trainer._train_batch(rng_np))
            sync(dev)
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss))
    finally:
        L.Conv3x3x3BiasReLU = Conv3x3x3BiasReLU
    if starts != rec["starts"].tolist():
        raise AssertionError(f"retrain: patch starts {starts}, JAX's "
                             f"{rec['starts'].tolist()}")
    return losses, np.asarray(norms), times, trainer.params


def phase_retrain(dev, smi, root):
    """Phase 20 (path ``retrain``): U-Net a's training on the card.  (1)
    the conv Function's gradients at every 3x3x3 layer of its training
    batch, 8 x (160, 160, 16) and its pooled levels, without the ReLU
    (``phase_train_grads``); (2) the first 30 steps of ``retrain_unet``
    from the trained weights on JAX's batches (its patch starts and affine
    draws, ``jax_unet_train_record.npz``), each step's loss held as phase
    14 holds StarDist's through step ``LOSS_PER_STEP``, and the mean update
    norm of every leaf over steps 1-30 within twice JAX's one-ulp spread
    (at least ``LOSS_LATER_TOL``); the same steps with every dW zeroed must
    fail that; (3) the example with ``--retrain 2`` in a fresh folder
    (``--min-size LEG_RETRAIN_MIN_SIZE``):
    validation losses, checkpoints at each improvement,
    ``select_unet_weights`` of the best, then tracking with the chosen
    weights.  Returns the 30 steps' launches, the readings, and the
    replay (losses, ms per step, parameters, launches, the legacy folder)
    that phase 27 holds its mesh run to."""
    from t3dct_torch.models.unet3d import unet3_a
    from t3dct_torch.scripts import use_unet_legacy
    grads = phase_train_grads(dev, unet_train_layers(unet3_a()), relu=False,
                              tag="retrain grad")
    rec = np.load(LEGACY_ASSETS / "jax_unet_train_record.npz")
    leaves = json.loads(str(rec["leaves"]))
    folder, _ = write_legacy_folder(root / "retrain", n_vols=1)

    (losses, norms, times, params), launches = counted(
        lambda: replay_unet_record(dev, folder, rec))
    spread = rec["update_norms_nudged"]
    hold_losses("U-Net retrain", losses, rec["losses"], len(rec["losses"]),
                rec["losses_nudged"])
    hold_update_norms("U-Net retrain", norms, rec["update_norms"], spread,
                      leaves, first=0)
    _, faulty, _, _ = replay_unet_record(dev, folder, rec, zero_dw=True)
    _, fault_dep, fault_bound = late_norm_departures(
        faulty, rec["update_norms"], spread, first=0)
    print(f"[retrain] planted fault, every dW zeroed: update-norm departure "
          f"{fault_dep:.3e} (bound {fault_bound:.3e})")
    if fault_dep <= fault_bound:
        raise AssertionError("the update norms pass a U-Net trainer with "
                             "every dW zeroed")
    step_ms = float(np.mean(times[3:]))
    print(f"[retrain] {smi}: {step_ms:.2f} ms per step (mean of steps "
          f"4-30; every step {[round(v, 1) for v in times]}); per step forward "
          f"{grads['fwd']:.3f} ms, dX {grads['dx']:.3f} ms (least "
          f"{grads['dx_bound']:.3f}), dW (library) {grads['dw']:.3f} ms "
          f"(least {grads['dw_bound']:.3f}); launches over 30 steps "
          f"{launches}")
    # the example's second phase with --retrain 2 in a fresh folder
    from t3dct_torch.engine.metrics import tracking_id_metrics
    ex, centers = write_legacy_folder(root / "retrain_example")
    t0 = time.perf_counter()
    tracker = use_unet_legacy.main([
        "--folder", str(ex), "--volume-num", str(BENCH_VOLS), "--siz-xyz",
        str(Y), str(X), str(Z), "--min-size", str(LEG_RETRAIN_MIN_SIZE),
        "--unet-model", "unet3_a.npz", "--ffn-model", "ffn.npz",
        "--skip-segmentation", "--retrain", "2", "--device", str(dev)])
    wall = time.perf_counter() - t0
    val = tracker.val_losses
    best = int(np.argmin(val))
    ckpts = sorted(p.name for p in Path(tracker.paths.unet_weights).glob(
        "unet_weights_retrain_step*.npz"))
    want = [f"unet_weights_retrain_step{i}.npz" for i in range(1, len(val))
            if val[i] < min(val[:i])]
    coords = tracker.history.r_tracked_coordinates
    acc = tracking_id_metrics(dict(enumerate(coords, start=1)), centers,
                              VOXEL_SIZE, BENCH_VOLS)
    print(f"[retrain] example --retrain 2 --min-size {LEG_RETRAIN_MIN_SIZE}:"
          f" {wall:.1f} s; val losses {[round(v, 5) for v in val]}, "
          f"checkpoints {ckpts}, chose step {best}; {len(coords)} volumes "
          f"tracked, {len(coords[0])} cells; cells found per volume "
          f"{[len(c) for c in tracker.history.r_segmented_coordinates]}; "
          f"strict recall {acc['strict_recall']}, identity switches "
          f"{acc['id_switches']}")
    if ckpts != want or len(coords) != BENCH_VOLS or \
            not all(np.isfinite(c).all() for c in coords) or \
            (Path(tracker.paths.unet_weights) /
             "unet3_retrained.npz").is_file() != (best > 0):
        raise AssertionError("retrain example: checkpoints or tracking")
    replay = dict(losses=losses, times=times, params=params,
                  launches=launches, folder=folder)
    return replay, launches, dict(unet_step_ms=step_ms,
                          unet_train_fwd_ms=grads["fwd"],
                          unet_train_dx_ms=grads["dx"],
                          unet_train_dx_bound_ms=grads["dx_bound"],
                          unet_train_dw_ms=grads["dw"],
                          unet_train_dw_bound_ms=grads["dw_bound"],
                          unet_train_grad_max_rel_err=grads["max_rel_err"])


def phase_variants(dev, smi, root, folder, errs):
    """Phase 21: U-Net variants b and c.  Every 3x3x3 layer shape of one
    bench volume's tile batch against the plain version (seeded weights,
    ``conv_err``); then vol 1's segmentation through ``Tracker(
    unet_variant=...)`` with seeded intensity-path weights, on the card
    (timed) and, on a (64, 48, 24) crop of it, on the card against the
    CPU: the same cells, labels ``LABELS_EQUAL``.  Keeps each
    kernel's largest error in ``errs``."""
    import torch
    from t3dct_torch.models.layers import glorot_uniform
    from t3dct_torch.models.unet3d import get_unet, with_intensity_path
    from t3dct_torch.ops.tiling import plan_tiles
    from t3dct_torch.io.imageio import read_image_ts, save_label_slices
    gen = torch.Generator().manual_seed(21)
    vol1 = read_image_ts(1, str(folder / "data" / LEG_IMAGE), (1, Z + 1))
    crop = vol1[:64, :48]
    save_label_slices(crop, root / "crop" / "data", LEG_IMAGE, 1,
                      use_8_bit=False, compression=None)
    for variant in "bc":
        spec = get_unet(variant)
        n_tiles = len(plan_tiles((Y, X, Z), spec.tile_shape,
                                 (24, 24, 2)).origins)
        worst = {}
        for (*shape, ci, co), n in unet_conv_layers(spec).items():
            xin = torch.relu(torch.randn((n_tiles,) + tuple(shape) + (ci,),
                                         generator=gen)).to(dev)
            w = glorot_uniform((3, 3, 3, ci, co), 27 * ci, 27 * co, gen, dev)
            b = (torch.randn((co,), generator=gen) * 0.1).to(dev)
            kernel, err, tol = conv_err(xin, w, b, False)
            del xin
            if not err <= tol:
                raise AssertionError(f"variant {variant} conv {shape} "
                                     f"{ci}->{co}: {kernel} {err} > {tol}")
            errs[kernel] = max(errs.get(kernel, 0.0), err)
            worst[kernel] = max(worst.get(kernel, (0.0, 0.0)), (err, tol))
        print(f"[variants] {variant}: every 3x3x3 layer on {n_tiles} tiles "
              f"of {spec.tile_shape} against the plain version: " +
              ", ".join(f"{k} max_abs_err {e:.3e} (tol {t:.3e})"
                        for k, (e, t) in sorted(worst.items())))
        params, state = spec.init(torch.Generator().manual_seed(0),
                                  device="cpu")
        params = with_intensity_path(params, spec, threshold=LEG_THRESHOLD)
        out = {}
        for d, where, siz in ((dev, folder, (Y, X, Z)),
                              (dev, root / "crop", crop.shape),
                              (torch.device("cpu"), root / "crop",
                               crop.shape)):
            tracker = legacy_tracker(d, where, siz=siz, unet_variant=variant)
            tracker.load_unet_arrays(spec, params, state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seg = tracker._segment_array(tracker._read_volume(1))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            out[(d.type, siz)] = (seg, ms)
        (full, ms), = [v for (k, siz), v in out.items() if siz == (Y, X, Z)]
        card, _ = out[("cuda", crop.shape)]
        cpu, cpu_ms = out[("cpu", crop.shape)]
        same = float((card.segmentation_auto.cpu() ==
                      cpu.segmentation_auto).float().mean())
        print(f"[variants] {variant} {smi}: vol 1 seg {ms:.1f} ms on the "
              f"card, {len(full.r_coordinates_segment)} cells; crop "
              f"{crop.shape}: card {len(card.r_coordinates_segment)} cells, "
              f"CPU {len(cpu.r_coordinates_segment)} ({cpu_ms:.0f} ms), "
              f"labels equal {same:.5f}, probabilities off by max "
              f"{float((card.image_cell_bg.cpu() - cpu.image_cell_bg).abs().max()):.2e}")
        if len(card.r_coordinates_segment) != \
                len(cpu.r_coordinates_segment) or same < LABELS_EQUAL:
            raise AssertionError(f"variant {variant}: card and CPU disagree")


# phase 22: the reference's Keras topology over the bench scene: the
# committed seeded Keras model (assets/keras/sd_keras/, converted from a
# reference stardist folder), held to JAX's record of the same run
KERAS_ASSETS = ROOT / "3deecelltracker_tpu_torch" / "assets" / "keras"
# labels equal per recorded volume
KERAS_LABELS_EQUAL = 0.999
# volume 1's maps through the kernels, and through the network's plain
# version on the card, each against JAX's record: f32 summed in another
# order (the bounds of JAX's own TensorFlow test,
# tests/test_keras_import.py).  Two maps that each lie within these bounds
# of the record lie within twice them of each other: the kernels' against
# the plain version's.
KERAS_PROB_ATOL, KERAS_DIST_ATOL = 1e-5, 1e-4
# the tiled sweep of one volume: y cut in tiles, the receptive-field shrink
KERAS_TILE = (None, 256, None)


def plain_convs():
    """A context in which every 3x3x3 conv of ``models.layers`` runs the
    plain version (cuDNN with TF32 off) on the card: the whole network's
    plain version, launching none of the port's kernels."""
    import contextlib
    import torch
    from t3dct_torch.models import layers
    from t3dct_torch.ops.hopper_conv import conv3x3x3_bias_relu_plain

    class Plain:
        @staticmethod
        def apply(x, w, b, relu, compute_dtype=torch.float32):
            return conv3x3x3_bias_relu_plain(x, w, b, relu, compute_dtype)

    @contextlib.contextmanager
    def ctx():
        saved = layers.Conv3x3x3BiasReLU
        layers.Conv3x3x3BiasReLU = Plain
        try:
            yield
        finally:
            layers.Conv3x3x3BiasReLU = saved

    return ctx()


def keras_layer_rows(dev, smi, model, grid_shape, errs):
    """Every 3x3x3 layer of the Keras backbone at the bench volume's shapes
    (its seeded weights, a seeded ReLU'd input) through the router: error
    against the plain version, the kernel's time, cuDNN's, the plain
    version's and the bounds; the full-resolution pre-grid layers printed
    one by one.  Returns the sums per kernel (launches of no path)."""
    import torch
    gen = torch.Generator().manual_seed(22)
    sums = {}
    tc_total = lib_total = 0.0
    for name, shape, co in backbone_layers(model, 1, grid_shape):
        xin = torch.relu(torch.randn(shape[1:], generator=gen)).to(dev)
        p = model.params[name]
        r = conv_row(xin, p["w"], p["b"], relu=True)
        del xin
        if not r["err"] <= r["tol"]:
            raise AssertionError(f"keras conv {name} {shape}: {r['kernel']}"
                                 f" error {r['err']} > {r['tol']}")
        errs[r["kernel"]] = max(errs.get(r["kernel"], 0.0), r["err"])
        (t_b, by), (t_tc, by_tc) = r["bound"], r["tc_bound"]
        own = t_tc if r["kernel"] == "wgmma" else t_b
        acc = sums.setdefault(r["kernel"], dict(ms=0.0, plain_ms=0.0,
                                                library_ms=0.0,
                                                bound_ms=0.0))
        for key, v in (("ms", r["ms"]), ("plain_ms", r["plain_ms"]),
                       ("library_ms", r["library_ms"]), ("bound_ms", own)):
            acc[key] += v
        tc_total += t_tc
        lib_total += r["library_ms"]
        if name.startswith("pre"):
            acc[f"{name}_ms"] = r["ms"]
            acc[f"{name}_library_ms"] = r["library_ms"]
            acc[f"{name}_bound_ms"] = own
            acc[f"{name}_tc_bound_ms"] = t_tc
        print(f"[keras] {name} {'x'.join(map(str, shape[1:-1]))} "
              f"{shape[-1]}->{co}: {r['kernel']} {r['ms']:.3f} ms "
              f"{r['tflops']:.1f} TFLOP/s, max_abs_err {r['err']:.3e} (tol "
              f"{r['tol']:.3e}); cuDNN {r['library_ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms; least f32 {t_b:.4f} ms ({by}), "
              f"three-pass TF32 {t_tc:.4f} ms ({by_tc})")
    ms = sum(a["ms"] for a in sums.values())
    print(f"[keras] {smi}: backbone layers per volume {ms:.3f} ms (wgmma "
          f"{sums['wgmma']['ms']:.3f}, direct {sums['direct']['ms']:.3f}), "
          f"cuDNN f32 over the same layers {lib_total:.3f} ms, three-pass "
          f"TF32 bound {tc_total:.3f} ms; full resolution: pre0_0 "
          f"{sums['direct']['pre0_0_ms']:.3f} ms (cuDNN "
          f"{sums['direct']['pre0_0_library_ms']:.3f}, byte bound "
          f"{sums['direct']['pre0_0_bound_ms']:.4f}), pre0_1 "
          f"{sums['wgmma']['pre0_1_ms']:.3f} ms (cuDNN "
          f"{sums['wgmma']['pre0_1_library_ms']:.3f}, three-pass TF32 "
          f"bound {sums['wgmma']['pre0_1_bound_ms']:.3f})")
    return sums, dict(keras_backbone_layers_ms=ms,
                      keras_backbone_library_ms=lib_total,
                      keras_backbone_tc_bound_ms=tc_total)


def phase_keras(dev, smi, root, pattern, centers):
    """Phase 22: the Keras topology (``StarDist3DNet(arch="keras")``, the
    topology of every reference checkpoint) at the bench config, with the
    committed seeded model (``assets/keras/sd_keras/``, loaded by
    ``load_stardist_model`` without ``h5py``):
    (1) every 3x3x3 layer at the bench volume's shapes, the
    full-resolution pre0_0 (c_in = 1, the direct kernel) and pre0_1
    included, against the plain version, with times beside cuDNN's and
    the bounds; (2) volume 1's prob and dist maps through the kernels
    against the whole network's plain version on the card and against
    JAX's record (``jax_record_keras.npz``: the prob map, the dist at the
    kept cells) within ``KERAS_PROB_ATOL`` / ``KERAS_DIST_ATOL``, and the
    network's ms per volume; (3) ``segment_and_track(handoff="device")``
    over phase 11's TIFFs (path ``keras``), held to the record with phase
    11's rules and labels ``KERAS_LABELS_EQUAL``, seg and track ms per
    volume; (4) ``predict_instances_tiled`` of volume 1 with
    ``KERAS_TILE`` (path ``keras_tiled``): its prob map equals the whole
    pass beyond the Keras receptive field of the tiled faces
    (``TILED_INTERIOR_ATOL``)."""
    import shutil
    import torch
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track
    from t3dct_torch.engine.stardist import load_stardist_model
    from t3dct_torch.io.imageio import (fast_percentiles,
                                        load_2d_slices_at_time)
    from t3dct_torch.utils.device import upload_raw
    from t3dct_torch.utils.timing import CudaStageTimer
    record = np.load(KERAS_ASSETS / "jax_record_keras.npz")
    cands = []
    model = keep_candidates(load_stardist_model(
        "sd_keras", str(KERAS_ASSETS), device=dev), cands)
    if model.arch != "keras":
        raise AssertionError(f"sd_keras loaded as arch {model.arch!r}")
    div = model.net.div_by
    padded = tuple(-(-s // d) * d for s, d in zip((Z, Y, X), div))
    grid_shape = tuple(p // g for p, g in zip(padded, GRID))
    print(f"[keras] {smi}: arch keras, receptive field "
          f"{model.net.receptive_field()}, volume {(Z, Y, X)} padded to "
          f"{padded}, grid {grid_shape}; plan " + ", ".join(
              f"{n} {ci}->{co}" for n, ci, co, _ in model.net.conv_plan()))
    errs = {}
    sums, totals = keras_layer_rows(dev, smi, model, grid_shape, errs)

    # (2) volume 1's maps
    raw1 = load_2d_slices_at_time(pattern, 1, do_normalize=False)
    mi, ma = (float(v) for v in fast_percentiles(raw1, (1.0, 99.8)))
    x1 = model._normalize(upload_raw(raw1, dev), (mi, ma))
    gz, gy, gx = model._grid_shape(x1.shape)
    (prob_k, dist_k), fwd_launches = counted(lambda: model.forward_grid(x1))
    with plain_convs():
        prob_p, dist_p = model.forward_grid(x1)
        plain_ms = cuda_ms(lambda: model.forward_grid(x1), reps=5)
    net_ms = cuda_ms(lambda: model.forward_grid(x1), reps=5)
    torch.cuda.synchronize()
    prob_k, dist_k = prob_k[:gz, :gy, :gx], dist_k[:gz, :gy, :gx]
    prob_p, dist_p = prob_p[:gz, :gy, :gx], dist_p[:gz, :gy, :gx]
    pts = torch.from_numpy(record["dist_1_points"]).long().to(dev)
    jax_prob = torch.from_numpy(record["prob_1"]).to(dev)
    jax_dist = torch.from_numpy(record["dist_1"]).to(dev)
    off = (prob_k - prob_p).abs()
    at = np.unravel_index(int(off.argmax()), off.shape)
    maps = dict(
        prob_vs_jax=float((prob_k - jax_prob).abs().max()),
        dist_vs_jax=float((dist_k[pts[:, 0], pts[:, 1], pts[:, 2]]
                           - jax_dist).abs().max()),
        plain_prob_vs_jax=float((prob_p - jax_prob).abs().max()),
        plain_dist_vs_jax=float((dist_p[pts[:, 0], pts[:, 1], pts[:, 2]]
                                 - jax_dist).abs().max()),
        prob_vs_plain=float(off.max()),
        dist_vs_plain=float((dist_k - dist_p).abs().max()))
    del dist_p
    print(f"[keras] {smi}: volume 1's maps through the kernels (launches "
          f"{fwd_launches['conv3x3x3_wgmma']} wgmma, "
          f"{fwd_launches['conv3x3x3_direct']} direct) against JAX's record: "
          f"prob {maps['prob_vs_jax']:.3e}, dist at {len(pts)} kept cells "
          f"{maps['dist_vs_jax']:.3e}; the plain version's against it: prob "
          f"{maps['plain_prob_vs_jax']:.3e}, dist "
          f"{maps['plain_dist_vs_jax']:.3e} (bounds {KERAS_PROB_ATOL:.0e} / "
          f"{KERAS_DIST_ATOL:.0e}); the kernels' against the plain "
          f"version's: prob {maps['prob_vs_plain']:.3e} (at {at}, prob "
          f"{float(prob_p[at]):.6f}), dist {maps['dist_vs_plain']:.3e} "
          f"(bounds twice those); the network {net_ms:.3f} ms per volume "
          f"(plain version {plain_ms:.3f} ms), its layers "
          f"{totals['keras_backbone_layers_ms']:.3f} ms, cuDNN's "
          f"{totals['keras_backbone_library_ms']:.3f} ms, three-pass TF32 "
          f"bound {totals['keras_backbone_tc_bound_ms']:.3f} ms")
    bad = [f"{k} {v}" for k, v in maps.items() if not v <= (
        (KERAS_PROB_ATOL if "prob" in k else KERAS_DIST_ATOL)
        * (2 if k.endswith("plain") else 1))]

    # (3) the bench scene through the entry point
    results = root / "results_keras"
    shutil.copytree(root / "results" / "manual_vol1",
                    results / "manual_vol1")
    timer = CudaStageTimer()
    coords, launches = counted(lambda: segment_and_track(
        pattern, model, results, str(results / "manual_vol1" / "*.tif"),
        ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS),
        TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        timer=timer, handoff="device", device=dev))
    print(f"[keras] launches {launches}")
    plan = [(ci, co, 1) for _, ci, co, k in model.net.conv_plan()
            if tuple(k) == (3, 3, 3)]
    check_conv_launches("keras", launches, BENCH_VOLS, stem_count(plan))
    check_flood_launches("keras", launches, BENCH_VOLS)
    held, got_metrics, _ = hold_to_record(
        "keras", record, results, coords, centers, cands, model,
        labels_equal=KERAS_LABELS_EQUAL)
    bad += held
    seg_ms, track_ms = np.mean(timer.times["seg"]), \
        np.mean(timer.times["track"])
    wall = timer.times["call"][0] / BENCH_VOLS
    print(f"[keras] {smi}: wall {wall:.2f} ms per volume for the whole "
          f"call; seg {seg_ms:.2f} ms, track {track_ms:.2f} ms per volume")

    # (4) the tiled sweep of volume 1 against the whole pass
    (_, tiled_prob), tiled_launches = counted(
        lambda: model.predict_instances_tiled(
            upload_raw(raw1, dev), tile_shape=KERAS_TILE,
            norm_minmax=(mi, ma)))
    n_tiles = len(model.plan_tiling((Z, Y, X), KERAS_TILE).origins)
    m = -(-model.net.receptive_field()[1] // GRID[1])
    diff = np.abs(tiled_prob[:, m:-m] - prob_k.cpu().numpy()[:, m:-m])
    print(f"[keras] tiled: {n_tiles} tiles of {KERAS_TILE}, launches "
          f"{tiled_launches}; prob map against the whole pass beyond {m} "
          f"grid voxels of the tiled faces: max {diff.max():.3e} "
          f"({int((diff > 0).sum())} of {diff.size} voxels not bit-equal)")
    if not diff.max() <= TILED_INTERIOR_ATOL:
        bad.append(f"tiled interior prob map {diff.max()}")
    if tiled_launches["conv3x3x3_wgmma"] <= 0 or \
            tiled_launches["conv3x3x3_direct"] <= 0:
        bad.append(f"tiled launches {tiled_launches}")
    if bad:
        raise AssertionError(f"keras phase: {bad}")
    times = dict(totals, keras_network_ms=net_ms,
                 keras_network_plain_ms=plain_ms,
                 keras_seg_ms_per_vol=seg_ms,
                 keras_track_ms_per_vol=track_ms,
                 keras_wall_ms_per_vol=wall,
                 keras_maps_max_abs_err=maps,
                 keras_strict_recall=got_metrics["strict_recall"],
                 keras_id_switches=got_metrics["id_switches"])
    return launches, tiled_launches, sums, times, errs


# phase 23: JAX's default precision, bfloat16, on the legacy path: the bf16
# forms of the conv against their plain version layer by layer, then the
# legacy folder flow with the Tracker as JAX builds it, held to JAX's bf16
# records (tests/test_torch_legacy_record.py --write-bf16) within twice
# JAX's own spread (--nudged-bf16: the same run, U-Net nudged by one ulp,
# one run per seed; vol 1's probabilities kept with the first)
LEG_BF16_RECORD = "jax_legacy_record_bf16.npz"
LEG_BF16_RECORD_ENSEMBLE = "jax_legacy_record_ensemble_bf16.npz"
LEG_BF16_SPREAD = ("jax_legacy_record_bf16_nudged.npz",) + tuple(
    f"jax_legacy_record_bf16_nudged_s{s}.npz" for s in range(2, 13))
# a bf16 layer against its plain version (an f32 conv of the rounded
# operands): each product is exact, and the wgmma accumulator truncates
# each sum it adds (a stage's 144 products), so within 1e-5 of sum |x w|
# + |b| per output
BF16_RTOL = 1e-5


def bf16_layers():
    """``(model, input shape, c_out, count per volume)`` of every 3x3x3
    layer phase 23 holds in bf16: U-Net a, b and c on their tile batches
    of the bench volume (``unet_conv_layers``), and the bench backbone in
    both archs on one volume (``backbone_layers``)."""
    import types
    from t3dct_torch.config import StarDistConfig
    from t3dct_torch.models.stardist3d import StarDist3DNet
    from t3dct_torch.models.unet3d import get_unet
    from t3dct_torch.ops.tiling import plan_tiles
    out = []
    for variant in "abc":
        spec = get_unet(variant)
        n = len(plan_tiles((Y, X, Z), spec.tile_shape,
                           LEG_SEG["shrink"]).origins)
        out += [(f"unet_{variant}", (n,) + tuple(shape) + (ci,), co, k)
                for (*shape, ci, co), k in unet_conv_layers(spec).items()]
    cfg = StarDistConfig(n_rays=96, grid=GRID, anisotropy=(9.2, 1.0, 1.0),
                         unet_n_filter_base=32, net_conv_after_unet=128)
    for arch in ("tpu", "keras"):
        net = StarDist3DNet(cfg, arch)
        rows = {}
        for _, shape, co in backbone_layers(types.SimpleNamespace(
                config=cfg, arch=arch, net=net), 1, CONV_LAYERS[0][:3]):
            rows[(shape, co)] = rows.get((shape, co), 0) + 1
        out += [(f"backbone_{arch}", shape, co, k)
                for (shape, co), k in rows.items()]
    return out


def bf16_bn(co, gen, dev):
    """Seeded BatchNorm eval parameters, not the identity: (mean, inv,
    beta), ``inv`` as ``layers.batchnorm`` computes it."""
    import torch
    mean = torch.randn((co,), generator=gen) * 0.2
    var = torch.rand((co,), generator=gen) + 0.5
    scale = torch.rand((co,), generator=gen) + 0.5
    beta = torch.randn((co,), generator=gen) * 0.2
    return tuple(t.to(dev) for t in (mean, torch.rsqrt(var + 1e-3) * scale,
                                     beta))


def bf16_row(xin, w, b, bn, act):
    """One layer in bf16 through the router, in both modes of the kernel
    ``route`` names, against their plain versions: the bf16 layer (f32
    out, ReLU where ``act`` is) within ``BF16_RTOL`` of sum |x w| + |b|;
    the U-Net block (``bn`` = (mean, inv, beta), ``act``, bf16 out) the
    rounding of a value within ``BF16_RTOL`` of sum |x w| + |b| times
    |inv| (and 2^-21 of itself, BatchNorm's f32 roundings) of the plain
    block's f32 value, and bit-equal to the kernel's own f32 mode followed
    by PyTorch's activation, BatchNorm and ``.to(torch.bfloat16)``.  Times:
    the block, the plain block, the bf16 layer, cuDNN's bf16 conv (bf16 in
    and out, copies made outside the timing), the TF32 kernel on the f32
    input; bounds: the block's (bf16 in and out) and the f32-activation
    one (f32 in and out)."""
    import torch
    from t3dct_torch.ops import hopper_conv as hc
    from t3dct_torch.utils.roofline import (conv_bf16_bound, conv_flop,
                                            library_conv)
    bf = torch.bfloat16
    mean, inv, beta = bn
    relu = act == "relu"
    reps, warmup = (2, 1) if xin.numel() > 2 ** 28 else (5, 1)
    xf = xin.float()
    plain = hc.conv3x3x3_bias_relu_plain(xf, w, b, False, bf)
    scale = hc.conv3x3x3_bias_relu_plain(hc.round_bf16(xf).abs_(),
                                         hc.round_bf16(w).abs_(), b.abs(),
                                         False)
    layer = hc.conv3x3x3_bias_relu(xin, w, b, relu, compute_dtype=bf)
    diff = (layer - (torch.relu(plain) if relu else plain)).abs_()
    err = float(diff.max())
    rel = float((diff / scale).max())
    del diff, layer
    got = hc.conv3x3x3_block_bf16(xin, w, b, mean, inv, beta, act)
    f32 = hc.conv3x3x3_bias_relu(xin, w, b, False, compute_dtype=bf)
    unequal = int((got != ((hc.activation(f32, act) - mean) * inv +
                           beta).to(bf)).sum())
    del f32
    v = (hc.activation(plain, act) - mean) * inv + beta
    eps = BF16_RTOL * scale * inv.abs() + v.abs() * 2.0 ** -21
    g32 = got.float()
    outside = int(((g32 < (v - eps).to(bf).float()) |
                   (g32 > (v + eps).to(bf).float())).sum())
    block_err = float((g32 - v).abs().max())
    del plain, scale, v, eps, g32, got
    ms = cuda_ms(functools.partial(hc.conv3x3x3_block_bf16, xin, w, b, mean,
                                   inv, beta, act), reps, warmup)
    plain_ms = cuda_ms(functools.partial(hc.conv3x3x3_block_bf16_plain, xin,
                                         w, b, mean, inv, beta, act),
                       reps, warmup)
    layer_ms = cuda_ms(functools.partial(hc.conv3x3x3_bias_relu, xin, w, b,
                                         relu, compute_dtype=bf),
                       reps, warmup)
    tf32_ms = cuda_ms(functools.partial(hc.conv3x3x3_bias_relu, xf, w, b,
                                        relu), reps, warmup)
    xb, wb, bb = xin.to(bf), w.to(bf), b.to(bf)
    library_ms = cuda_ms(lambda: library_conv(xb, wb, bb), reps, warmup)
    del xb, xf
    return dict(kernel=hc.route(xin.shape[-1], w.shape[-1], bf), err=err,
                rel=rel, unequal=unequal, outside=outside,
                block_err=block_err, ms=ms, plain_ms=plain_ms,
                layer_ms=layer_ms, tf32_ms=tf32_ms, library_ms=library_ms,
                bound=conv_bf16_bound(xin, w, b, 2, bn=bn),
                f32_act_bound=conv_bf16_bound(xin, w, b, 4, x_bytes=4),
                tflops=conv_flop(xin, w.shape[-1]) / ms / 1e9)


def bf16_layer_rows(dev, smi):
    """Every layer of ``bf16_layers`` on a seeded input as the network
    hands it on (bf16 ReLU'd values; the stems' f32 tiles) with glorot
    weights and seeded BatchNorm parameters (``bf16_row``, the U-Nets'
    activations, the backbones' ReLU), held as ``bf16_row`` says; returns
    per (model, kernel) the sums per volume and each kernel's largest
    error (launches of no path)."""
    import torch
    from t3dct_torch.models.layers import glorot_uniform
    gen = torch.Generator().manual_seed(23)
    dgen = torch.Generator(device=dev).manual_seed(23)
    acts = {"unet_a": "leaky_relu", "unet_b": "relu", "unet_c": "leaky_relu"}
    sums, errs = {}, {}
    for model, shape, co, count in bf16_layers():
        ci = shape[-1]
        xin = torch.randn(shape, generator=dgen, device=dev)
        if ci > 1:
            xin = torch.relu_(xin).to(torch.bfloat16)
        w = glorot_uniform((3, 3, 3, ci, co), 27 * ci, 27 * co, gen, dev)
        b = (torch.randn((co,), generator=gen) * 0.1).to(dev)
        r = bf16_row(xin, w, b, bf16_bn(co, gen, dev),
                     acts.get(model, "relu"))
        del xin
        torch.cuda.empty_cache()
        t_b, by = r["bound"]
        print(f"[bf16] {model} {'x'.join(map(str, shape[:-1]))} {ci}->{co} "
              f"x{count}: {r['kernel']} block {r['ms']:.3f} ms "
              f"{r['tflops']:.1f} TFLOP/s, bf16 layer {r['layer_ms']:.3f} "
              f"ms; layer error {r['rel']:.2e} of sum |x w| + |b| "
              f"(max_abs_err {r['err']:.3e}); block: {r['outside']} outside "
              f"the bound, {r['unequal']} unequal to the f32 mode + PyTorch "
              f"epilogue; cuDNN bf16 {r['library_ms']:.3f} ms, TF32 kernel "
              f"{r['tf32_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms; bound "
              f"{t_b:.4f} ms ({by}), f32 activations "
              f"{r['f32_act_bound'][0]:.4f} ms")
        if not (r["rel"] <= BF16_RTOL and r["outside"] == 0 and
                r["unequal"] == 0):
            raise AssertionError(f"bf16 conv {model} {shape} -> {co}: "
                                 f"{r['kernel']} layer error {r['rel']} of "
                                 f"the scale (bound {BF16_RTOL}), block "
                                 f"{r['outside']} outside its bound, "
                                 f"{r['unequal']} unequal to the f32 mode")
        errs[r["kernel"]] = max(errs.get(r["kernel"], 0.0), r["err"])
        acc = sums.setdefault((model, r["kernel"]), dict(by={}))
        for key in ("ms", "plain_ms", "layer_ms", "tf32_ms", "library_ms"):
            acc[key] = acc.get(key, 0.0) + count * r[key]
        acc["bound_ms"] = acc.get("bound_ms", 0.0) + count * t_b
        acc["f32_act_bound_ms"] = acc.get("f32_act_bound_ms", 0.0) + \
            count * r["f32_act_bound"][0]
        acc["by"][by] = acc["by"].get(by, 0.0) + count * t_b
        acc["block_max_abs_err"] = max(acc.get("block_max_abs_err", 0.0),
                                       r["block_err"])
    for (model, kernel), acc in sums.items():
        acc["bound_by"] = max(acc["by"], key=acc["by"].get)
        print(f"[bf16] {smi}: {model} {kernel} per volume: block "
              f"{acc['ms']:.3f} ms, bf16 layer {acc['layer_ms']:.3f} (TF32 "
              f"kernel {acc['tf32_ms']:.3f}, cuDNN bf16 "
              f"{acc['library_ms']:.3f}, plain {acc['plain_ms']:.3f}; bound "
              f"{acc['bound_ms']:.3f} ms, by {acc['bound_by']}; f32 "
              f"activations {acc['f32_act_bound_ms']:.3f} ms)")
    return sums, errs


def apply_split_ms(apply, reps=3):
    """``apply()``, a bf16 U-Net apply, timed whole and, in the same runs,
    around each of its conv blocks: CUDA events recorded on the stream
    just before and just after every call of
    ``layers.conv3x3x3_block_bf16`` inside the apply (the kernel, and the
    wrapper's host work where the card waits on it).  Returns ms per
    apply ``(whole, blocks)``; raises unless the calls bracketed equal the
    bf16 kernels' launches counted over the same runs, so no launch of
    the apply lies outside a pair.  Prints how many of one apply's conv
    launches a ``torch.profiler`` trace in this process holds (traces here
    have held only some)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from t3dct_torch.models import unet3d
    layers, marks = unet3d.L, []
    inner = layers.conv3x3x3_block_bf16

    def bracketed(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = inner(*args, **kw)
        ev[1].record()
        marks.append(ev)
        return out

    def runs():
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(reps):
            apply()
        end.record()
        return start, end

    layers.conv3x3x3_block_bf16 = bracketed
    try:
        apply()
        marks.clear()
        (start, end), n = counted(runs)
    finally:
        layers.conv3x3x3_block_bf16 = inner
    launched = n["conv3x3x3_wgmma_bf16"] + n["conv3x3x3_direct_bf16"]
    if launched != len(marks) or sum(n[k] for k in ("conv3x3x3_wgmma",
                                                    "conv3x3x3_direct")):
        raise AssertionError(f"bf16 apply: {len(marks)} blocks bracketed, "
                             f"launches {n}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        apply()
        torch.cuda.synchronize()
    held = sum(e.device_type == torch.autograd.DeviceType.CUDA and
               ("conv_bf16_kernel<" in e.name or "stem_kernel<" in e.name)
               for e in prof.events())
    print(f"[bf16] a profiler trace of one apply holds {held} of its "
          f"{launched // reps} conv launches")
    return (start.elapsed_time(end) / reps,
            sum(a.elapsed_time(b) for a, b in marks) / reps)


def unet_bf16_ms(dev, smi, folder):
    """U-Net a with the trained weights, b and c with seeded ones, each on
    vol 1's tile batch of its own tile plan: ms a volume in bf16 (a also
    in f32, and how far the two networks' probabilities lie apart: the
    precision's own effect, not a fault), and, from a run with CUDA events
    around each conv block inside the apply (``apply_split_ms``), that
    run's time split into its conv blocks and the rest of the call (pools,
    upsampling and concatenation, the output conv, the host's work between
    launches where the card waits on it)."""
    import torch
    from t3dct_torch.config import SegmentationConfig
    from t3dct_torch.engine.segmentation import MEDIAN_STRIDE, UNetSegmenter
    from t3dct_torch.io.imageio import read_image_ts
    from t3dct_torch.models.unet3d import get_unet
    from t3dct_torch.ops.lcn import normalize_image
    from t3dct_torch.ops.tiling import extract_tiles, pad_for_tiles
    from t3dct_torch.utils.checkpoint import load_pytree
    from t3dct_torch.utils.device import upload_raw
    raw = upload_raw(read_image_ts(1, str(folder / "data" / LEG_IMAGE),
                                   (1, Z + 1)), dev)
    norm = normalize_image(raw, LEG_SEG["noise_level"],
                           median_stride=MEDIAN_STRIDE)
    out = {}
    for variant in "abc":
        spec = get_unet(variant)
        params, state = spec.init(torch.Generator().manual_seed(0),
                                  device=dev)
        if variant == "a":
            params, state = load_pytree((params, state),
                                        LEGACY_ASSETS / "unet3_a.npz")
        seg = UNetSegmenter(spec, params, state, SegmentationConfig(
            **LEG_SEG), (Y, X, Z), device=dev)
        tiles = extract_tiles(pad_for_tiles(norm, seg.plan),
                              seg.plan)[..., None]
        ms, probs = {}, {}
        dts = (torch.bfloat16, torch.float32) if variant == "a" else \
            (torch.bfloat16,)
        with torch.no_grad():
            for dt in dts:
                probs[dt] = spec.apply(params, state, tiles,
                                       compute_dtype=dt)
                ms[dt] = cuda_ms(lambda: spec.apply(params, state, tiles,
                                                    compute_dtype=dt), 3, 1)
            whole, conv = apply_split_ms(lambda: spec.apply(
                params, state, tiles, compute_dtype=torch.bfloat16))
        bf = ms[torch.bfloat16]
        line = (f"[bf16] {smi}: U-Net {variant} on vol 1's "
                f"{tiles.shape[0]} tiles of {tuple(tiles.shape[1:4])}: bf16 "
                f"{bf:.3f} ms a volume; with events around its blocks "
                f"{whole:.3f} ms, of which the conv blocks {conv:.3f} ms and "
                f"the rest {whole - conv:.3f} ms")
        if variant == "a":
            a, b = probs[torch.bfloat16], probs[torch.float32]
            line += (f"; f32 {ms[torch.float32]:.3f} ms; bf16 against f32: "
                     f"max {float((a - b).abs().max()):.3e}, "
                     f"{int(((a > 0.5) != (b > 0.5)).sum())} voxels across "
                     f"0.5")
            out["unet_f32_ms"] = ms[torch.float32]
        print(line)
        key = "unet" if variant == "a" else f"unet_{variant}"
        out.update({f"{key}_bf16_ms": bf, f"{key}_bf16_evented_ms": whole,
                    f"{key}_bf16_conv_ms": conv,
                    f"{key}_bf16_rest_ms": whole - conv})
        del tiles, probs, params, state, seg
        torch.cuda.empty_cache()
    return out


def legacy_run_record(tracker, centers):
    """What JAX's records keep (``tests/test_torch_legacy_record.py::
    tracker_record``) of a port run: cells per volume, ``auto_vol1``,
    tracked coordinates and labels per volume, the metrics, and vol 1's
    probabilities as the run cached them (float16)."""
    from t3dct_torch.engine.metrics import tracking_id_metrics
    from t3dct_torch.io.imageio import imread_stack

    def labels(folder, name):
        return imread_stack(sorted(Path(folder).glob(name))).transpose(1, 2,
                                                                       0)
    h = tracker.history
    coords = {t: c for t, c in enumerate(h.r_tracked_coordinates, start=1)}
    out = dict(cells=np.array([len(c) for c in h.r_segmented_coordinates]),
               auto_vol1=labels(tracker.paths.auto_segmentation_vol1,
                                "auto_R_t0001_z*"),
               metrics=tracking_id_metrics(coords, centers, VOXEL_SIZE,
                                           BENCH_VOLS),
               prob_1=np.load(Path(tracker.paths.unet_cache) /
                              "t000001.npy"))
    for t in range(1, BENCH_VOLS + 1):
        out[f"coords_{t}"] = coords[t]
        out[f"labels_{t}"] = labels(tracker.paths.track_results,
                                    "track_results_t%06i_z*.tif" % t)
    return out


def legacy_departure(run, record, probs=None):
    """How far ``run`` (``legacy_run_record``, or a record) lies from
    ``record``: vol 1's probabilities in float16 where ``run`` keeps them
    (largest difference, its 99.9th percentile, voxels on the other side
    of 0.5; against ``probs`` where the record keeps none), cells per
    volume (volumes off, the largest), ``auto_vol1`` and the tracked labels
    (share of voxels unequal, the largest over t), tracked coordinates
    (the largest median distance over t, the largest distance), strict
    recall and identity switches."""
    def metrics(r):
        m = r["metrics"]
        return m if isinstance(m, dict) else json.loads(str(m))
    out = {}
    if "prob_1" in run:
        p = np.asarray(run["prob_1"], np.float32)
        q = np.asarray(record["prob_1"] if "prob_1" in record else probs,
                       np.float32)
        d = np.abs(p - q)
        out.update(prob_max=float(d.max()),
                   prob_p999=float(np.percentile(d, 99.9)),
                   prob_across=int(((p > 0.5) != (q > 0.5)).sum()))
    off = np.abs(np.asarray(run["cells"]) - np.asarray(record["cells"]))
    dist = [np.linalg.norm(run[f"coords_{t}"] - record[f"coords_{t}"],
                           axis=1) for t in range(1, BENCH_VOLS + 1)]
    got, want = metrics(run), metrics(record)
    return dict(
        out, cells_vols=int((off > 0).sum()), cells_max=int(off.max()),
        auto_unequal=float((run["auto_vol1"] != record["auto_vol1"]).mean()),
        labels_unequal=max(float((run[f"labels_{t}"] !=
                                  record[f"labels_{t}"]).mean())
                           for t in range(1, BENCH_VOLS + 1)),
        coord_median=max(float(np.median(x)) for x in dist),
        coord_max=max(float(x.max()) for x in dist),
        recall=abs(got["strict_recall"] - want["strict_recall"]),
        switches=abs(got["id_switches"] - want["id_switches"]))


def jax_spread(single, nudged):
    """JAX's own spread: per statistic, the largest departure of its
    ``nudged`` runs from its ``single`` record (``legacy_departure``)."""
    out = {}
    for rec in nudged:
        for k, v in legacy_departure(rec, single).items():
            out[k] = max(out.get(k, v), v)
    return out


def hold_legacy_bf16(path, record, single, nudged, run):
    """A bf16 legacy run (``legacy_run_record``) against JAX's bf16
    ``record`` within twice JAX's own spread (``jax_spread`` of its
    ``nudged`` runs from its single record, ``single``), per statistic.
    Returns what failed and the departures."""
    spread = jax_spread(single, nudged)
    dep = legacy_departure(run, record, single["prob_1"])
    for k in dep:
        print(f"[{path}] {k}: {dep[k]:.6g} against JAX's record (JAX's own "
              f"spread {spread[k]:.6g}, bound {2 * spread[k]:.6g})")
    want = json.loads(str(record["metrics"]))
    print(f"[{path}] strict recall {run['metrics']['strict_recall']}, "
          f"identity switches {run['metrics']['id_switches']} (JAX's record "
          f"{want['strict_recall']}, {want['id_switches']}); cells found per "
          f"volume {run['cells'].tolist()}, JAX's {record['cells'].tolist()}")
    bad = [f"{k} {dep[k]}" for k in dep if not dep[k] <= 2 * spread[k]]
    if not all(np.isfinite(run[f"coords_{t}"]).all()
               for t in range(1, BENCH_VOLS + 1)):
        bad.append("coordinates not finite")
    return bad, dep


def phase_bf16(dev, smi, folder, centers):
    """Phase 23 (paths ``legacy_bf16``, ``legacy_bf16_ensemble``): JAX's
    default precision on the legacy path.  (1) ``bf16_layer_rows``, both
    modes of both bf16 kernels; (2) ``unet_bf16_ms``, U-Net a, b and c;
    (3) phase 18's folder flow with the ``Tracker`` as
    JAX builds it (bfloat16), then ``ensemble=20`` in the same folder, each
    held to its bf16 record (``hold_legacy_bf16``), every counter reset
    before and read after: the bf16 ``wgmma`` conv, the bf16 stem once per
    volume, no f32 conv, the flood and cc; seg and track ms per volume."""
    import torch
    from t3dct_torch.utils.timing import CudaStageTimer
    sums, errs = bf16_layer_rows(dev, smi)
    times = unet_bf16_ms(dev, smi, folder)
    single = np.load(LEGACY_ASSETS / LEG_BF16_RECORD)
    nudged = [np.load(LEGACY_ASSETS / name) for name in LEG_BF16_SPREAD]
    launches, bad = {}, []
    for path, name, kw in (
            ("legacy_bf16", LEG_BF16_RECORD, {}),
            ("legacy_bf16_ensemble", LEG_BF16_RECORD_ENSEMBLE,
             dict(ensemble=LEG_ENSEMBLE))):
        timer = CudaStageTimer()
        tracker, launches[path] = counted(lambda: timed_legacy_example(
            legacy_tracker(dev, folder, **kw), timer))
        n = launches[path]
        print(f"[{path}] launches {n}")
        if tracker.segmenter.compute_dtype != torch.bfloat16 or \
                n["conv3x3x3_wgmma_bf16"] <= 0 or \
                n["conv3x3x3_direct_bf16"] != BENCH_VOLS or \
                n["conv3x3x3_wgmma"] or n["conv3x3x3_direct"] or \
                n["cc_label"] <= 0:
            raise AssertionError(f"{path}: not JAX's bf16 U-Net on the "
                                 f"bf16 kernels: {n}")
        check_flood_launches(path, n, BENCH_VOLS)
        held, dep = hold_legacy_bf16(path, np.load(LEGACY_ASSETS / name),
                                     single, nudged,
                                     legacy_run_record(tracker, centers))
        bad += [f"{path}: {b}" for b in held]
        seg, track = timer.times["seg"], timer.times["track"]
        wall = timer.times["call"][0] / BENCH_VOLS
        print(f"[{path}] {smi}: wall {wall:.2f} ms per volume for the whole "
              f"call; seg {np.mean(seg):.2f} ms per volume "
              f"{[round(v, 1) for v in seg]}; track {np.mean(track):.2f} ms "
              f"per volume {[round(v, 1) for v in track]}")
        times.update({f"{path}_seg_ms": float(np.mean(seg)),
                      f"{path}_track_ms": float(np.mean(track)),
                      f"{path}_wall_ms": wall,
                      f"{path}_departures": dep})
    if bad:
        raise AssertionError(f"bf16 legacy runs off JAX's records: {bad}")
    return sums, errs, times, launches


def nonfinite_rows(dev):
    """Phase 24 (``ROADMAP.md`` C.10): the bf16 tensor-core kernel on U-Net
    a's c_in % 16 == 8 shapes, whose last (only) 16-channel chunk is a
    half one, with +Inf, -Inf and NaN planted in single activations more
    than two voxels apart (no output sums two of them), in both batch
    items: the f32-out layer mode and the block mode (LeakyReLU, eval
    BatchNorm, bf16 out) against their plain versions on the CPU (oneDNN's
    direct sum keeps +-Inf), exactly where the plain output is not finite
    (the same NaNs, the same signed Infs) and within ``BF16_RTOL`` of sum
    |x w| + |b| (the block: its rounding) elsewhere.  Returns each case's
    non-finite outputs and largest finite error."""
    import torch
    from t3dct_torch.ops import hopper_conv as hc
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(24)
    rows, bad = [], []
    for ci, co in ((8, 16), (8, 8)):
        x = torch.relu(torch.randn((2, 6, 40, 40, ci), generator=gen))
        for b, (z, y, xx), c in ((0, (3, 10, 10), ci - 1),
                                 (1, (2, 30, 25), 0)):
            x[b, z, y, xx, c] = float("inf")
            x[b, z, y + 6, xx + 6, c] = float("-inf")
            x[b, z, y - 5, xx + 12, c] = float("nan")
        x = hc.round_bf16(x)
        w = torch.randn((3, 3, 3, ci, co), generator=gen) / (27 * ci) ** 0.5
        bias = torch.randn((co,), generator=gen) * 0.1
        bn = bf16_bn(co, gen, "cpu")
        finite = torch.where(torch.isfinite(x), x, 0.0)
        scale = hc.conv3x3x3_bias_relu_plain(
            finite.abs(), hc.round_bf16(w).abs(), bias.abs(), False)
        plain = hc.conv3x3x3_bias_relu_plain(x, w, bias, False, bf)
        xd, wd, bd = x.to(dev).to(bf), w.to(dev), bias.to(dev)
        mean, inv, beta = bn
        for mode in ("layer", "block"):
            if mode == "layer":
                got = hc.conv3x3x3_bias_relu(xd, wd, bd, False,
                                             compute_dtype=bf).cpu()
                want, eps = plain, BF16_RTOL * scale
                lo = hi = None
            else:
                got = hc.conv3x3x3_block_bf16(
                    xd, wd, bd, *(t.to(dev) for t in bn),
                    "leaky_relu").cpu().float()
                want = hc.conv3x3x3_block_bf16_plain(
                    x, w, bias, mean, inv, beta, "leaky_relu").float()
                v = (hc.activation(plain, "leaky_relu") - mean) * inv + beta
                eps = BF16_RTOL * scale * inv.abs() + v.abs() * 2.0 ** -21
                lo, hi = (v - eps).to(bf).float(), (v + eps).to(bf).float()
            nonfinite = ~torch.isfinite(want)
            same_mask = torch.equal(nonfinite, ~torch.isfinite(got))
            same_values = torch.equal(
                got[nonfinite].nan_to_num(0.0, 1.0, -1.0),
                want[nonfinite].nan_to_num(0.0, 1.0, -1.0)) and \
                torch.equal(got[nonfinite].isnan(), want[nonfinite].isnan())
            ok = ~nonfinite & torch.isfinite(got)
            if lo is None:
                outside = int(((got - want).abs() > eps)[ok].sum())
            else:
                outside = int(((got < lo) | (got > hi))[ok].sum())
            err = float((got - want).abs()[ok].max())
            n_nan = int(want.isnan().sum())
            n_inf = int(want.isinf().sum())
            rows.append(dict(shape=f"{ci}->{co}", mode=mode, nan=n_nan,
                             inf=n_inf, err=err, outside=outside))
            print(f"[c10] {ci} -> {co} {mode}: {n_nan} NaN and {n_inf} "
                  f"+-Inf outputs in the plain version, the kernel's "
                  f"{'the same' if same_mask and same_values else 'DIFFER'}"
                  f"; finite outputs max error {err:.3e}, {outside} "
                  f"outside the bound")
            if not (same_mask and same_values) or outside or not \
                    (n_nan and n_inf):
                bad.append((ci, co, mode))
    if bad:
        raise AssertionError(f"C.10: the half chunk's non-finite outputs "
                             f"differ from the plain version: {bad}")
    return rows


# the synthetic demo's bound on its median tracking error at t = 6 (real
# units), set before the demo's first card run from JAX's
# examples/synthetic_demo.py run once on the CPU, which printed 2.14 (its
# StarDist, trained on the CPU, kept no cell; the cells standing still
# would score 2.96): JAX's figure with a quarter of room for the card's
# other training numerics (TF32 convs)
DEMO_MAX_ERROR = 1.25 * 2.14


def phase_mesh(dev, smi, root, pattern, folder):
    """Phase 25: the mesh entry points over an NCCL world of one, each
    held bit for bit against what it is made of (see the module
    docstring).  Returns the launches of each path and the times."""
    import shutil
    import torch
    from t3dct_torch.config import (SegmentationConfig, StarDistConfig,
                                    TrackingConfig)
    from t3dct_torch.engine.pipeline import (segment_and_track,
                                             track_timelapse)
    from t3dct_torch.engine.segmentation import UNetSegmenter
    from t3dct_torch.engine.stardist import StarDist3D
    from t3dct_torch.io.imageio import read_image_ts
    from t3dct_torch.models.unet3d import get_unet
    from t3dct_torch.parallel import make_mesh, multihost
    from t3dct_torch.scripts import segment_large_volume as script
    from t3dct_torch.utils.checkpoint import load_pytree
    from t3dct_torch.utils.device import upload_raw
    t_phase = time.perf_counter()
    multihost.initialize(num_processes=1, process_id=0,
                         store=str(root / "nccl_store"))
    launches, times, bad = {}, {}, []
    try:
        mesh = make_mesh(1)

        def tree_bytes(d):
            return {str(p.relative_to(d)): p.read_bytes()
                    for p in sorted(d.rglob("*")) if p.is_file()}

        def same_tree(name, got, want, subs):
            for sub in subs:
                if tree_bytes(got / sub) != tree_bytes(want / sub):
                    bad.append(f"{name}: {sub} differs from the run "
                               f"without a mesh")

        def same_coords(name, got, want_root):
            from t3dct_torch.io.artifacts import ResultsTree
            tree = ResultsTree(want_root)
            for t, c in got.items():
                if not np.array_equal(c, tree.load_coords_real(t)):
                    bad.append(f"{name}: t={t} coordinates differ")

        # segment_and_track over phase 11's TIFFs
        results = root / "results_mesh"
        shutil.copytree(root / "results" / "manual_vol1",
                        results / "manual_vol1")
        model = trained_model(dev, [])
        t0 = time.perf_counter()
        coords, launches["mesh_bench"] = counted(lambda: segment_and_track(
            pattern, model, results, str(results / "manual_vol1" / "*.tif"),
            ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS),
            TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
            handoff="device", mesh=mesh))
        times["mesh_bench_ms"] = 1e3 * (time.perf_counter() - t0) / \
            BENCH_VOLS
        same_tree("mesh_bench", results, root / "results",
                  ("seg", "auto_vol1", "track_results"))
        same_coords("mesh_bench", coords, root / "results")
        # ensemble track_timelapse over phase 12's seg/
        results = root / "results_mesh_ensemble"
        shutil.copytree(root / "results_disk" / "seg", results / "seg")
        shutil.copytree(root / "results" / "manual_vol1",
                        results / "manual_vol1")
        t0 = time.perf_counter()
        coords, launches["mesh_ensemble"] = counted(
            lambda: track_timelapse(
                results, str(results / "manual_vol1" / "*.tif"),
                ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, BENCH_VOLS),
                grid=GRID, config=TrackingConfig(**ENSEMBLE),
                verbose=False, mesh=mesh))
        times["mesh_ensemble_ms"] = 1e3 * (time.perf_counter() - t0) / \
            BENCH_VOLS
        same_tree("mesh_ensemble", results, root / "results_ensemble",
                  ("track_results",))
        same_coords("mesh_ensemble", coords, root / "results_ensemble")
        # predict_instances_sharded on phase 17's volume, at the threshold
        # that keeps the top 1% of the grid (as phase 17's batch check)
        sd = StarDist3D(StarDistConfig(**script.CONFIG), max_candidates=512,
                        render_box=(9, 17, 17), device=dev)
        x = np.random.default_rng(0).random(ZEBRAFISH, np.float32)
        (_, _), prob = sd.predict_instances_tiled(x, ZEBRAFISH_TILE)
        thr = float(np.quantile(prob[2:-2, 2:-2, 2:-2], 0.99))
        kw = dict(tile_shape=ZEBRAFISH_TILE, prob_thresh=thr)
        t0 = time.perf_counter()
        want = sd.predict_instances_tiled(x, **kw)
        tiled_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        got, launches["mesh_sharded"] = counted(
            lambda: sd.predict_instances_sharded(x, mesh=mesh, **kw))
        times["mesh_sharded_ms"] = 1e3 * (time.perf_counter() - t0)
        times["mesh_sharded_tiled_ms"] = tiled_ms
        (g_lab, g_det), g_prob = got
        (w_lab, w_det), w_prob = want
        if not (np.array_equal(g_prob, w_prob)
                and np.array_equal(g_lab, w_lab)
                and all(np.array_equal(g_det[k], w_det[k])
                        for k in ("points", "prob", "dist"))):
            bad.append("mesh_sharded differs from predict_instances_tiled")
        print(f"[mesh] sharded zebrafish: {len(g_det['points'])} instances "
              f"at prob {thr:.4f}, {times['mesh_sharded_ms']:.1f} ms "
              f"against the tiled run's {tiled_ms:.1f} ms")
        # the U-Net segmenter on the legacy folder's vol 1, bf16
        spec = get_unet("a")
        params, state = load_pytree(
            spec.init(torch.Generator().manual_seed(0), device=dev),
            LEGACY_ASSETS / "unet3_a.npz")
        raw = read_image_ts(1, str(folder / "data" / LEG_IMAGE), (1, Z + 1))
        cfg = SegmentationConfig(**LEG_SEG)
        plain = UNetSegmenter(spec, params, state, cfg, (Y, X, Z),
                              max_cells=LEG_MAX_CELLS, device=dev)
        t0 = time.perf_counter()
        want = plain.segment(raw)
        torch.cuda.synchronize()
        times["unet_seg_ms"] = 1e3 * (time.perf_counter() - t0)
        tiles = UNetSegmenter(spec, params, state, cfg, (Y, X, Z),
                              max_cells=LEG_MAX_CELLS, mesh=mesh)
        for name, seg in (("unet_probs_ms", plain),
                          ("mesh_unet_tiles_probs_ms", tiles)):
            seg.predict_cellregions(raw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seg.predict_cellregions(raw)
            torch.cuda.synchronize()
            times[name] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        got, launches["mesh_unet_tiles"] = counted(lambda: tiles.segment(
            raw))
        times["mesh_unet_tiles_ms"] = 1e3 * (time.perf_counter() - t0)
        if not (torch.equal(got.image_cell_bg, want.image_cell_bg)
                and torch.equal(got.segmentation_auto,
                                want.segmentation_auto)):
            bad.append("mesh_unet_tiles differs from the segmenter "
                       "without a mesh")
        halo = UNetSegmenter(spec, params, state, cfg, (Y, X, Z),
                             max_cells=LEG_MAX_CELLS, mesh=mesh,
                             mesh_mode="halo")
        probs, launches["mesh_unet_halo"] = counted(
            lambda: halo.predict_cellregions(raw))
        t0 = time.perf_counter()
        halo.predict_cellregions(raw)
        torch.cuda.synchronize()
        times["mesh_unet_halo_ms"] = 1e3 * (time.perf_counter() - t0)
        norm = halo._normalize(upload_raw(raw, dev))
        tp = spec.pool[0] ** len(spec.down_filters)
        padded = torch.nn.functional.pad(norm, (
            0, (-Z) % spec.pool[2] ** len(spec.down_filters),
            0, (-X) % spec.pool[1] ** len(spec.down_filters), 0, (-Y) % tp))
        h = halo.halo
        ext = torch.nn.functional.pad(padded, (0, 0, 0, 0, h, h))
        direct = spec.apply(params, state, ext[None, ..., None],
                            compute_dtype=torch.bfloat16)[
            0, h:h + padded.shape[0], ..., 0][:Y, :X, :Z]
        if not torch.equal(probs, direct):
            bad.append("mesh_unet_halo differs from the U-Net applied to "
                       "the zero-extended volume")
        apart = int(((probs - want.image_cell_bg).abs() > 1e-2).sum())
        print(f"[mesh] U-Net a bf16 on vol 1: segment "
              f"{times['unet_seg_ms']:.1f} ms, over the mesh "
              f"{times['mesh_unet_tiles_ms']:.1f} ms (tile mode); "
              f"probabilities (warm) {times['unet_probs_ms']:.2f} ms, over "
              f"the mesh {times['mesh_unet_tiles_probs_ms']:.2f} ms (tile "
              f"mode) and {times['mesh_unet_halo_ms']:.2f} ms (halo mode, "
              f"halo {h}; {apart} voxels more than 1e-2 from the tile "
              f"sweep's: the halo sweep has no tile seams)")
    finally:
        torch.distributed.destroy_process_group()
    for path, n in launches.items():
        print(f"[mesh] {path} launches {n}")
    need = {"mesh_bench": ("conv3x3x3_wgmma", "conv3x3x3_direct",
                           "flood_slices"),
            "mesh_ensemble": ("flood_slices",),
            "mesh_sharded": ("conv3x3x3_wgmma", "conv3x3x3_direct"),
            "mesh_unet_tiles": ("conv3x3x3_wgmma_bf16",
                                "conv3x3x3_direct_bf16", "flood_slices",
                                "cc_label"),
            "mesh_unet_halo": ("conv3x3x3_wgmma_bf16",
                               "conv3x3x3_direct_bf16")}
    for path, names in need.items():
        for name in names:
            if launches[path][name] <= 0:
                bad.append(f"{path}: {name} never launched")
    print(f"[mesh] {smi}: segment_and_track over the mesh "
          f"{times['mesh_bench_ms']:.2f} ms per volume (the whole call; "
          f"phase 11 without it {WALLS.get('bench', float('nan')):.2f}); "
          f"ensemble track_timelapse over the mesh "
          f"{times['mesh_ensemble_ms']:.2f} ms per volume (phase 13 "
          f"without it {WALLS.get('bench_ensemble', float('nan')):.2f}); "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise AssertionError(f"mesh: {bad}")
    return launches, times


def phase_demo(dev, smi, root):
    """Phase 26: the port's synthetic demo on the card, the example's whole
    recipe; each stage's seconds and the median tracking error at t = 6,
    held to ``DEMO_MAX_ERROR``."""
    from t3dct_torch.scripts import synthetic_demo as demo
    t0 = time.perf_counter()
    out, launches = counted(lambda: demo.main(["--out", str(root / "demo")]))
    total = time.perf_counter() - t0
    print(f"[demo] launches {launches}")
    print(f"[demo] {smi}: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["seconds"].items())
        + f"; {total:.1f} s in all; median tracking error at t="
        f"{demo.N_VOLS} {out['median_error']:.4f} real units (bound "
        f"{DEMO_MAX_ERROR})")
    bad = [name for name in ("conv3x3x3_wgmma", "conv3x3x3_direct",
                             "flood_slices") if launches[name] <= 0]
    if bad or not out["median_error"] <= DEMO_MAX_ERROR:
        raise AssertionError(f"demo: kernels never launched {bad}, median "
                             f"error {out['median_error']} against "
                             f"{DEMO_MAX_ERROR}")
    return launches, dict(demo_s=total, demo_median_error=out[
        "median_error"], **{f"demo_{k}_s": v for k, v in
                            out["seconds"].items()})


# phase 27: the mesh trainers against phases 14 and 20 without a mesh,
# within the CPU tests' tolerances (tests/test_torch_mesh_train.py):
# StarDist's first MESH_SD_FIRST steps (the recipe is chaotic: an ulp
# parts JAX's own runs by 3.6e-4 at step 2 and by tens of percent past
# step 16, so its later steps are held to JAX's record alone), the FFN's
# first MESH_FFN_FIRST, and U-Net a's every step (JAX's nudged runs part by
# 1e-6 over its 30) and its parameters in the norm of the whole tree
MESH_SD_FIRST, MESH_SD_RTOL = 3, 1e-3
MESH_FFN_FIRST, MESH_FFN_RTOL = 3, 2e-5
MESH_UNET_RTOL, MESH_UNET_PARAM_RTOL = 1e-4, 1e-3


def param_departure(got, want):
    """(the largest relative departure of a leaf in its norm, the whole
    tree's) of two parameter trees of tensors."""
    from t3dct_torch.utils.checkpoint import leaves_with_paths
    pairs = [(a.detach().double(), b.detach().double()) for (_, a), (_, b)
             in zip(leaves_with_paths(got), leaves_with_paths(want))]
    leaf = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
               for a, b in pairs)
    whole = (sum(float(((a - b) ** 2).sum()) for a, b in pairs)
             / sum(float((b ** 2).sum()) for _, b in pairs)) ** 0.5
    return leaf, whole


def phase_mesh_train(dev, smi, root, cfg, trainer_kw, ffn_seed, steps,
                     replay):
    """Phase 27 (paths ``mesh_train_stardist``, ``mesh_train_ffn``,
    ``mesh_train_unet``): the trainers' ``mesh=`` over an NCCL world of
    one.  StarDist and the FFN: phase 14's record runs from JAX's inits,
    over ``make_mesh(1)`` and without a mesh; U-Net a: phase 20's 30
    replayed steps on JAX's batches over ``make_mesh(1, 1)`` through
    ``make_sharded_unet_train_step`` (the halo path at spatial size 1: zero
    halos, the kernels on the x + 2 shapes, the synchronized BatchNorm),
    beside phase 20's run without a mesh (``replay``).  Each mesh run is
    held to JAX's record with its phase's gates and to the run without a
    mesh (``MESH_*``); the conv launches must equal the run without a
    mesh's; prints ms per step beside it (host-clocked between two syncs)
    and the parameters' departure."""
    import torch
    from t3dct_torch.models.train_ffn import DataGeneratorFFN, TrainFFN
    from t3dct_torch.models.train_stardist import TrainStarDist3D
    from t3dct_torch.parallel import make_mesh, multihost
    from t3dct_torch.utils.convert import load_npz
    from t3dct_torch.utils.optim import record_update_norms
    t_phase = time.perf_counter()
    rec = np.load(TRAIN_ASSETS / "jax_train_record.npz")
    urec = np.load(LEGACY_ASSETS / "jax_unet_train_record.npz")
    img, lab, _ = vol1_training_data()
    sd_init = load_npz(TRAIN_ASSETS / "sd_init.npz")
    ffn_init = load_npz(TRAIN_ASSETS / "ffn_init.npz")
    with np.load(ASSETS / "jax_record.npz") as bench_rec:
        cloud = ffn_cloud_file(root / "pts_mesh.txt",
                               bench_rec["seg_coords_1"])

    def step_ms(trainer):
        """Wrap ``trainer.train_step`` so that each step is timed on the
        host between two syncs; returns the list its times go to."""
        step, times = trainer.train_step, []

        def train_step(*args):
            sync(dev)
            t0 = time.perf_counter()
            out = step(*args)
            sync(dev)
            times.append(1e3 * (time.perf_counter() - t0))
            return out
        trainer.train_step = train_step
        return times

    def sd_run(tag, mesh):
        tr = TrainStarDist3D(cfg, basedir=root / f"sd_mesh_{tag}",
                             device=dev, mesh=mesh, **trainer_kw)
        tr.start_from(sd_init)
        times = step_ms(tr)          # the update norms outside the clock
        norms = record_update_norms(tr)
        losses, launches = counted(lambda: tr.train(
            [img], [lab], epochs=steps, steps_per_epoch=1, verbose=False))
        return dict(losses=losses, norms=norms, launches=launches,
                    ms=float(np.mean(times[3:])), params=tr.params)

    def ffn_run(tag, mesh):
        tf = TrainFFN("ffn", points1_path=cloud,
                      basedir=root / f"ffn_mesh_{tag}", seed=ffn_seed,
                      device=dev, mesh=mesh)
        tf.start_from((ffn_init["0"], ffn_init["1"]))
        tf.points_generator = DataGeneratorFFN(rec["ffn_points_t1"],
                                               seed=ffn_seed, device=dev)
        times = step_ms(tf)
        losses, launches = counted(lambda: tf.train(
            num_epochs=steps, iteration=0, verbose=False))
        return dict(losses=losses, launches=launches,
                    ms=float(np.mean(times[3:])), params=tf.params)

    def first_off(name, got, want, n, rtol):
        rel = np.abs(np.asarray(got) - want) / np.abs(want)
        print(f"[mesh train] {name}: rel diff per step to the run without "
              f"a mesh {fmt_rel(rel)} (held through step {n} within "
              f"{rtol:g})")
        return [i + 1 for i in range(n) if not rel[i] <= rtol]

    multihost.initialize(num_processes=1, process_id=0,
                         store=str(root / "nccl_store_train"))
    try:
        mesh = make_mesh(1)
        sd = {tag: sd_run(tag, m) for tag, m in (("mesh", mesh),
                                                 ("plain", None))}
        ffn = {tag: ffn_run(tag, m) for tag, m in (("mesh", mesh),
                                                   ("plain", None))}
        (losses, norms, times, params), unet_launches = counted(
            lambda: replay_unet_record(dev, replay["folder"], urec,
                                       mesh=make_mesh(1, 1)))
    finally:
        torch.distributed.destroy_process_group()
    hold_losses("StarDist (mesh)", sd["mesh"]["losses"], rec["sd_losses"],
                LOSS_PER_STEP, sd_spread(rec))
    hold_update_norms("StarDist (mesh)", sd["mesh"]["norms"],
                      rec["sd_update_norms"], sd_norm_spread(rec),
                      json.loads(str(rec["sd_update_leaves"])))
    hold_losses("FFN (mesh)", ffn["mesh"]["losses"], rec["ffn_losses"])
    hold_losses("U-Net retrain (mesh)", losses, urec["losses"],
                len(urec["losses"]), urec["losses_nudged"])
    hold_update_norms("U-Net retrain (mesh)", norms, urec["update_norms"],
                      urec["update_norms_nudged"],
                      json.loads(str(urec["leaves"])), first=0)
    bad = [f"StarDist step {i}" for i in first_off(
        "StarDist", sd["mesh"]["losses"], sd["plain"]["losses"],
        MESH_SD_FIRST, MESH_SD_RTOL)]
    bad += [f"FFN step {i}" for i in first_off(
        "FFN", ffn["mesh"]["losses"], ffn["plain"]["losses"],
        MESH_FFN_FIRST, MESH_FFN_RTOL)]
    bad += [f"U-Net step {i}" for i in first_off(
        "U-Net a", losses, replay["losses"], len(losses), MESH_UNET_RTOL)]
    runs = {"StarDist": (sd["mesh"]["params"], sd["plain"]["params"]),
            "FFN": (ffn["mesh"]["params"], ffn["plain"]["params"]),
            "U-Net a": (params, replay["params"])}
    departures = {k: param_departure(*v) for k, v in runs.items()}
    print(f"[mesh train] parameters after {steps} steps against the run "
          f"without a mesh, the largest leaf's relative departure and the "
          f"whole tree's: {departures}")
    if not departures["U-Net a"][1] <= MESH_UNET_PARAM_RTOL:
        bad.append(f"U-Net parameters {departures['U-Net a']}")
    launches = {"mesh_train_stardist": sd["mesh"]["launches"],
                "mesh_train_ffn": ffn["mesh"]["launches"],
                "mesh_train_unet": unet_launches}
    plain = {"mesh_train_stardist": sd["plain"]["launches"],
             "mesh_train_ffn": ffn["plain"]["launches"],
             "mesh_train_unet": replay["launches"]}
    convs = ("conv3x3x3_wgmma", "conv3x3x3_direct")
    for path, n in launches.items():
        k_steps = len(losses) if path == "mesh_train_unet" else steps
        per_step = {k: n[k] / k_steps for k in convs}
        want = {k: plain[path][k] / k_steps for k in convs}
        print(f"[mesh train] {path}: conv launches per step {per_step} "
              f"(without a mesh {want}); all launches {n}")
        if per_step != want:
            bad.append(f"{path}: conv launches {per_step}, without a mesh "
                       f"{want}")
        if path != "mesh_train_ffn":
            bad += [f"{path}: {k} never launched" for k in convs
                    if n[k] <= 0]
    unet_ms = float(np.mean(times[3:]))
    unet_plain_ms = float(np.mean(replay["times"][3:]))
    print(f"[mesh train] {smi}: ms per step over the mesh of one (without "
          f"it), the mean of steps 4-{steps}, each between two syncs: "
          f"StarDist {sd['mesh']['ms']:.2f} ({sd['plain']['ms']:.2f}), FFN "
          f"{ffn['mesh']['ms']:.2f} ({ffn['plain']['ms']:.2f}), U-Net a "
          f"{unet_ms:.2f} ({unet_plain_ms:.2f}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise AssertionError(f"mesh train: {bad}")
    return launches, dict(
        mesh_sd_step_ms=sd["mesh"]["ms"],
        mesh_sd_step_ms_plain=sd["plain"]["ms"],
        mesh_ffn_iter_ms=ffn["mesh"]["ms"],
        mesh_ffn_iter_ms_plain=ffn["plain"]["ms"],
        mesh_unet_step_ms=unet_ms, mesh_unet_step_ms_plain=unet_plain_ms,
        mesh_train_param_departure={k: v[1] for k, v in
                                    departures.items()})


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
    with tempfile.TemporaryDirectory() as tmp:
        bench, scene = phase_bench_scene(dev, smi, Path(tmp))
        disk = phase_bench_disk(dev, smi, Path(tmp), *scene)
        ens = phase_bench_ensemble(dev, smi, Path(tmp), *scene)
        cfg, trainer_kw, ffn_seed, steps = train_recipe()
        grads = phase_train_grads(dev, train_conv_layers(cfg))
        per_step = phase_train_records(dev, Path(tmp), cfg, trainer_kw,
                                       ffn_seed, steps)
        train, train_times = phase_train_recipe(
            dev, smi, Path(tmp), *scene, cfg, trainer_kw, ffn_seed,
            per_step)
        api = phase_volume_api(dev, smi, scene[0])
        tiled, tiled_times, tiled_errs = phase_tiled_bench(
            dev, smi, Path(tmp), *scene)
        zebra, zebra_times, zebra_errs = phase_zebrafish(dev, smi)
        t0 = time.perf_counter()
        leg_folder = write_legacy_folder(Path(tmp) / "legacy")
        print(f"[legacy_folder] scene: {BENCH_VOLS} volumes of {(Y, X, Z)} "
              f"(x, y, z) uint16 as {LEG_IMAGE} slices: "
              f"{time.perf_counter() - t0:.1f} s")
        leg_single, leg_single_times = phase_legacy_folder(dev, smi,
                                                           *leg_folder)
        leg_ens, leg_ens_times = phase_legacy_folder(dev, smi, *leg_folder,
                                                     ensemble=True)
        replay, retrain, retrain_times = phase_retrain(dev, smi, Path(tmp))
        variant_errs = {}
        phase_variants(dev, smi, Path(tmp), leg_folder[0], variant_errs)
        keras, keras_tiled, keras_sums, keras_times, keras_errs = \
            phase_keras(dev, smi, Path(tmp), *scene)
        bf16_sums, bf16_errs, bf16_times, bf16 = phase_bf16(dev, smi,
                                                            *leg_folder)
        t0 = time.perf_counter()
        c10 = nonfinite_rows(dev)
        print(f"[c10] phase {time.perf_counter() - t0:.1f} s")
        mesh, mesh_times = phase_mesh(dev, smi, Path(tmp), scene[0],
                                      leg_folder[0])
        demo, demo_times = phase_demo(dev, smi, Path(tmp))
        mesh_train, mesh_train_times = phase_mesh_train(
            dev, smi, Path(tmp), cfg, trainer_kw, ffn_seed, steps, replay)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    def counts(name):
        by_path = {"v1.0": launches[name], "legacy": leg[name],
                   "probe": probe_launches[name], "bench": bench[name],
                   "bench_disk": disk[name], "bench_ensemble": ens[name],
                   "train": train[name], "api": api[name],
                   "tiled": tiled[name], "zebrafish": zebra[name],
                   "legacy_folder": leg_single[name],
                   "legacy_ensemble": leg_ens[name],
                   "retrain": retrain[name], "keras": keras[name],
                   "keras_tiled": keras_tiled[name],
                   "legacy_bf16": bf16["legacy_bf16"][name],
                   "legacy_bf16_ensemble": bf16["legacy_bf16_ensemble"][name],
                   **{path: n[name] for path, n in mesh.items()},
                   "demo": demo[name],
                   **{path: n[name] for path, n in mesh_train.items()}}
        return dict(launches=sum(by_path.values()),
                    launches_by_path=by_path)

    # each conv kernel's max_abs_err is its largest over every shape held
    # against the plain version; the tiled paths' own ride along
    for name, acc in conv.items():
        for path, errs in (("tiled", tiled_errs), ("zebrafish", zebra_errs),
                           ("variants", variant_errs),
                           ("keras", keras_errs)):
            acc[f"{path}_max_abs_err"] = errs[name]
            acc["max_abs_err"] = max(acc["max_abs_err"], errs[name])
        # the Keras backbone's layers at the bench volume's shapes
        acc.update({f"keras_{k}": v for k, v in keras_sums[name].items()})

    def bf16_entry(kernel):
        """The bf16 form's readings: U-Net a's layers per volume as its
        headline numbers, the other models' sums by prefix."""
        head = dict(bf16_sums[("unet_a", kernel)])
        head.pop("by")
        out = dict(max_abs_err=bf16_errs[kernel], **head)
        for (model, k), acc in bf16_sums.items():
            if k == kernel and model != "unet_a":
                out.update({f"{model}_{key}": v for key, v in acc.items()
                            if key != "by"})
        return out

    kernels = [
        dict(name="conv3x3x3_wgmma_bf16", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/conv3x3x3_wgmma_bf16.cu",
             replaces="3deecelltracker_tpu/ops/pallas_conv.py:89",
             **counts("conv3x3x3_wgmma_bf16"), **bf16_entry("wgmma_bf16"),
             **bf16_times, c10_nonfinite=c10),
        dict(name="conv3x3x3_direct_bf16", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/conv3x3x3_bf16.cu",
             replaces="3deecelltracker_tpu/ops/pallas_conv.py:89",
             **counts("conv3x3x3_direct_bf16"), **bf16_entry("direct_bf16")),
        dict(name="conv3x3x3_wgmma", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/conv3x3x3_wgmma.cu",
             replaces="3deecelltracker_tpu/ops/pallas_conv.py:89",
             **counts("conv3x3x3_wgmma"), **conv["wgmma"],
             **{f"train_{k}_ms" if k != "max_rel_err" else
                "train_grad_max_rel_err": v for k, v in grads.items()},
             **train_times, **tiled_times, **zebra_times, **retrain_times,
             **{f"legacy_{k}": v for k, v in leg_single_times.items()},
             **{f"legacy_ensemble_{k}": v
                for k, v in leg_ens_times.items()}, **keras_times,
             **mesh_times, **demo_times, **mesh_train_times),
        dict(name="conv3x3x3_direct", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/conv3x3x3.cu",
             replaces="3deecelltracker_tpu/ops/pallas_conv.py:89",
             **counts("conv3x3x3_direct"), **conv["direct"]),
        dict(name="flood_slices", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/flood.cu",
             replaces="3deecelltracker_tpu/ops/pallas_kernels.py:162",
             **counts("flood_slices"), **flood,
             rounds_by_path={"v1.0": launches["flood_rounds"],
                             "legacy": leg["flood_rounds"],
                             "bench": bench["flood_rounds"],
                             "bench_disk": disk["flood_rounds"],
                             "bench_ensemble": ens["flood_rounds"],
                             "tiled": tiled["flood_rounds"],
                             "legacy_folder": leg_single["flood_rounds"],
                             "legacy_ensemble": leg_ens["flood_rounds"],
                             "keras": keras["flood_rounds"],
                             "keras_tiled": keras_tiled["flood_rounds"]}),
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
