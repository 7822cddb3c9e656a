"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them, and the torch/CUDA versions;
2. build: compiles both hand-written kernels from ``3deecelltracker_tpu_torch/
   csrc/`` with ``nvcc`` (into the package's ``_build/``);
3. conv check: the 3x3x3 conv kernel against its plain version (cuDNN with
   TF32 off) at every 3x3x3 layer shape of the bench backbone;
4. flood check: the per-slice flood kernel against its plain version on 24
   slices of 401x168 made from a synthetic label volume with overlaps;
5. the slice: ``segment_and_track_arrays`` on the bench scene, (24, 401, 168)
   uint16 volumes with 150 drifting cells (seed 0), at full bench width with
   seeded random weights: 1 reference volume, 1 warm volume, 5 timed ones.
   The launch counters are reset just before this run and must both be > 0
   after it;
6. small-scene parity: the slice on a small scene, once on the card and once
   on the CPU (plain versions); see ``phase_small_parity`` for the bound.

The second-to-last line is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``.  Weights are random: the tracking
accuracy printed is not a measure of the system.
"""

from __future__ import annotations

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
# f32 with a different summation order than cuDNN
CONV_RTOL, CONV_ATOL = 1e-5, 1e-6


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
    from t3dct_torch.utils import cuda_build
    for name in ("conv3x3x3", "flood"):
        t0 = time.perf_counter()
        cuda_build.load(name)
        print(f"[build] {name}: {time.perf_counter() - t0:.2f} s")


def phase_conv(dev):
    import torch
    from t3dct_torch.ops import hopper_conv
    from t3dct_torch.models.layers import glorot_uniform
    gen = torch.Generator().manual_seed(0)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for z, y, x, ci, co, count in CONV_LAYERS:
        xin = torch.relu(torch.randn((z, y, x, ci), generator=gen)).to(dev)
        w = glorot_uniform((3, 3, 3, ci, co), 27 * ci, 27 * co, gen, dev)
        b = (torch.randn((co,), generator=gen) * 0.1).to(dev)
        got = hopper_conv.conv3x3x3_bias_relu(xin, w, b)
        ref = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bound = CONV_RTOL * float(ref.abs().max()) + CONV_ATOL
        t_k = cuda_ms(lambda: hopper_conv.conv3x3x3_bias_relu(xin, w, b))
        t_p = cuda_ms(lambda: hopper_conv.conv3x3x3_bias_relu_plain(xin, w,
                                                                    b))
        print(f"[conv] ({z},{y},{x}) {ci}->{co} x{count}: max_abs_err "
              f"{err:.3e} (bound {bound:.3e})  kernel {t_k:.3f} ms  plain "
              f"{t_p:.3f} ms  kernel {2 * 27 * ci * co * z * y * x / t_k / 1e9:.1f}"
              f" TFLOP/s")
        if not err <= bound:
            raise AssertionError(f"conv ({z},{y},{x}) {ci}->{co}: error "
                                 f"{err} > {bound}")
        worst = max(worst, err)
        ms += count * t_k
        plain_ms += count * t_p
    print(f"[conv] backbone 3x3x3 layers per volume: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


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
    got, rounds = hopper_flood.flood_slices(elev, markers, mask)
    ref, rounds_p = hopper_flood.flood_slices_plain(elev, markers, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"flood: {(got != ref).sum().item()} voxels "
                             "differ from the plain version")
    t_k = cuda_ms(lambda: hopper_flood.flood_slices(elev, markers, mask),
                  reps=3, warmup=1)
    t_p = cuda_ms(lambda: hopper_flood.flood_slices_plain(elev, markers,
                                                          mask),
                  reps=3, warmup=1)
    print(f"[flood] {tuple(elev.shape)} overlap voxels {n_over}: exact, "
          f"rounds {rounds} (plain {rounds_p})  kernel {t_k:.3f} ms  plain "
          f"{t_p:.3f} ms")
    return dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p)


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
        StarDist3DNet(cfg).init(torch.Generator().manual_seed(0)), cfg)
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


def phase_slice(dev):
    import torch
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track_arrays
    from t3dct_torch.models.ffn import feature_distance_ffn
    from t3dct_torch.ops import hopper_conv, hopper_flood
    n_vols = 2 + N_TIMED
    t0 = time.perf_counter()
    from t3dct_torch.utils.synthetic import make_recording
    vols, centers, lab1 = make_recording(n_vols, N_CELLS, (Z, Y, X))
    print(f"[slice] scene {len(vols)} x {vols[0].shape} uint16, "
          f"{N_CELLS} cells: {time.perf_counter() - t0:.1f} s")
    model = bench_model(dev)
    ffn = feature_distance_ffn(torch.Generator().manual_seed(1), dev)
    timer = CudaStageTimer()
    hopper_conv.conv3x3x3_bias_relu.launches = 0
    hopper_flood.flood_slices.launches = 0
    t0 = time.perf_counter()
    res = segment_and_track_arrays(
        vols, model, lab1.transpose(1, 2, 0), ffn, VOXEL_SIZE, 10,
        TrackingConfig(beta=3.0, lambda_=3.0), device=dev, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv3x3x3_bias_relu": hopper_conv.conv3x3x3_bias_relu
                .launches, "flood_slices": hopper_flood.flood_slices.launches}
    print(f"[slice] wall {wall:.2f} s for {n_vols} volumes (incl. vol-1 "
          f"interpolate); launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
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
    launches = phase_slice(dev)
    phase_small_parity(dev)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        dict(name="conv3x3x3_bias_relu", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/conv3x3x3.cu",
             replaces="3deecelltracker_tpu/ops/pallas_conv.py:89",
             launches=launches["conv3x3x3_bias_relu"], **conv),
        dict(name="flood_slices", route="cuda",
             source="3deecelltracker_tpu_torch/csrc/flood.cu",
             replaces="3deecelltracker_tpu/ops/pallas_kernels.py:162",
             launches=launches["flood_slices"], **flood),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
