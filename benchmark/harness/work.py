"""The yardstick's arithmetic: the H100's peaks and the work a network needs
for a volume, counted once from the layer shapes.

Peaks are NVIDIA's H100 SXM data sheet (dense, 700 W), as the port's
``utils/roofline.py`` has them, with one change: a float32 product that
keeps float32 accuracy on the tensor cores costs three TF32 passes, so the
float32 peak here is 495 / 3 = 165 TFLOP/s.  The port's float32 conv
already runs faster than the 67 TFLOP/s that float32 reaches outside the
tensor cores, so a share against that rate could pass 100%.

Work is what the volume needs whatever computes it: each conv layer's FLOP
at the volume's own voxels at that layer's resolution (no padding to the
pooling grid, no voxel a tile repeats), each tensor read once and written
once.  A reading built on it cannot pass 100% unless the device did the
work faster than the data sheet allows.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_BYTES_S = 3.35e12
PEAK_TF32_FLOP_S = 495e12
TF32_PASSES = 3
PEAK_FLOP_S = {
    "float32": PEAK_TF32_FLOP_S / TF32_PASSES,
    "bfloat16": 989e12,
}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def peak_flop_s(precision: str) -> float:
    if precision not in PEAK_FLOP_S:
        raise ValueError(f"no peak for precision {precision!r}")
    return PEAK_FLOP_S[precision]


def layer_work(plan, cfg: dict, shape: Sequence[int], precision: str
               ) -> Dict[str, Dict[str, float]]:
    """{layer: {"flop", "bytes", "bound_s"}} of a StarDist network
    (``reference.stardist_net.conv_plan``) over one (z, y, x) volume.  A
    layer at level ``l`` sees ``prod(shape) / prod(grid) / prod(pool)**l``
    voxels; it reads its input and weights once and writes its output
    once."""
    grid, pool = cfg["grid"], cfg["unet_pool"]
    base = 1.0
    for s, g in zip(shape, grid):
        base *= s / g
    pool_vol = pool[0] * pool[1] * pool[2]
    eb = ELEMENT_BYTES[precision]
    peak = peak_flop_s(precision)
    out = {}
    for name, c_in, c_out, k, level in plan:
        vox = base / pool_vol ** level
        flop = 2.0 * k ** 3 * c_in * c_out * vox
        nbytes = eb * (vox * (c_in + c_out) + k ** 3 * c_in * c_out + c_out)
        out[name] = dict(flop=flop, bytes=nbytes,
                         bound_s=max(flop / peak, nbytes / PEAK_BYTES_S))
    return out


def network_flop(work: Dict[str, Dict[str, float]]) -> float:
    return sum(w["flop"] for w in work.values())


def network_bound_s(work: Dict[str, Dict[str, float]]) -> float:
    """The least time of the whole network: each layer's own bound, summed
    (a layer cannot start before its input exists)."""
    return sum(w["bound_s"] for w in work.values())
