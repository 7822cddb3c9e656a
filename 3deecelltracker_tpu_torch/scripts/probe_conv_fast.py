"""Conv probe: formulations of the backbone's hot 3x3x3 conv, timed side by
side on the card (counterpart of ``scripts/probe_conv_fast.py``).

At the full-resolution backbone shape (24, 204, 84) with c32 -> c32 and
c32 -> c128, in the JAX probe's layouts (channels-last ``(z, y, x, c)``,
DHWIO weights), it runs:

- ``baseline``: the port's ``models.layers.conv3d`` + ReLU, which launches
  the backbone conv's tensor-core kernel (``ops.hopper_conv``, ``csrc/
  conv3x3x3_wgmma.cu``: c_in 32 is on its rule);
- ``conv9gemm``: z-taps packed into K (K = 3 * c_in), nine (dy, dx) view
  products as plain ``torch.matmul``s;
- ``copad``: c_out zero-padded to 2x and 4x (c32: 64 and 128) through the
  baseline, then sliced;
- the ladder of hand-written kernels (``ops.ladder``): A ``x + 1`` (a
  streaming copy with eight 16-byte loads in flight a thread), B and B2
  the per-voxel channel product (a streaming TMA kernel), C the nine-view
  conv (three TF32 passes on the tensor cores, from TMA halo tiles of x),
  and E the backbone conv itself (the tensor-core kernel), beside cuDNN;
- the library conv, cuDNN ``F.conv3d`` with TF32 off, as the yardstick
  (``library_ms``); the port never calls it.

Every output is held against the plain conv (``hopper_conv.
conv3x3x3_bias_relu_plain``; ``x + 1`` and the einsum for A and B) within
``CONV_RTOL * max|ref| + CONV_ATOL`` (A exactly), and a miss raises.
Times are CUDA-event times on the card (warm-up, then the median of
``ROUNDS`` means of ``N_QUEUE`` launches); on the CPU ``run`` computes the
outputs and errors and writes no time.  Keys follow the JAX probe's JSON: a
record per width with ``gflop``, ``gemm9_*`` and ``copad*`` (first width
only), and the ladder entries ``pallas_*`` with ``ok`` and ``maxerr``; the
ladder runs on the first width's input and weights.  The port's additions:
``library_*`` per width, ``baseline_*`` and ``conv9view_*`` at the widths
the ladder does not cover (at the first width its E and C entries time
those two kernels), and per ladder entry its ``flop``, ``bytes`` and, on
the card, ``bound_ms`` (``utils.roofline.bound``), ``plain_ms`` and
``library_ms``.  The width records carry ``tc_bound_ms`` as well
(``utils.roofline.conv_tc_bound``: three TF32 passes at the tensor cores'
peak); C and E, which run on the tensor cores, have that as their
``bound_ms`` and the f32 one as ``f32_bound_ms``.  A, B, B2 and C also
carry their kernel's device time, ``device_ms`` (``conv9view_device_ms``
at the second width), from ``torch.profiler``'s trace (:func:`device_ms`):
the time per call includes the wrapper's host work where that is longer.
A also carries its library call's device time, ``library_device_ms``.
Each function is timed once on each input: the C and E
entries carry the first width's cuDNN reading, B2 carries B's matmul
reading.  Unlike the JAX probe, the bias is random rather than zero, so the
epilogue is checked.

    python -m 3deecelltracker_tpu_torch.scripts.probe_conv_fast \\
        --out chiprun_out/conv_fast_probe.json
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import layers
from ..ops import hopper_conv, ladder
from ..utils.device import select_device
from ..utils.roofline import (bound, conv_bound, conv_flop, conv_tc_bound,
                              library_conv, nbytes)

SHAPE = (24, 204, 84)       # the hot full-resolution backbone shape
C_IN = 32
C_OUTS = (32, 128)
N_QUEUE = 10       # launches per timed round
ROUNDS = 3
WARMUP = 2
# f32 sums in another order than the reference
CONV_RTOL, CONV_ATOL = 1e-5, 1e-6
# the CUDA kernels of ladder entries A, B and C (csrc/ladder.cu), and
# PyTorch's kernel of A's library call (x + 1), by the substring of their
# names that the profiler's trace shows
A_KERNEL = "add_one_kernel"
A_LIBRARY_KERNEL = "elementwise_kernel"
B_KERNEL = "pointwise_kernel"
C_KERNEL = "conv9view_wgmma_kernel"


def timed(fn: Callable[[], object]) -> float:
    """ms per call of ``fn`` on the card: CUDA events around ``N_QUEUE``
    calls, the median of ``ROUNDS`` such means, after ``WARMUP`` calls."""
    for _ in range(WARMUP):
        fn()
    means = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(N_QUEUE):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / N_QUEUE)
    return float(statistics.median(means))


def device_ms(fn: Callable[[], object], kernel: str, reps: int = 10,
              tries: int = 3) -> Optional[float]:
    """The device time of one launch of ``kernel`` (a substring of its
    name), from ``torch.profiler``'s CUDA trace over ``reps`` calls of
    ``fn`` after a warm-up: the kernel's device time over the launches the
    trace holds, so per call of a wrapper that launches it once.  A trace
    can miss some launches, or all of them, so the trace is taken again,
    up to ``tries`` times, until it holds one; None where none does."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key
                and getattr(e, "device_time_total", 0.0) > 0]
        n = sum(e.count for e in hits)
        if n:
            return sum(e.device_time_total for e in hits) / n / 1e3
    return None


def init_conv(c_in: int, c_out: int, seed: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    p = layers.init_conv3d((3, 3, 3), c_in, c_out, g, device)
    p["b"] = (torch.randn((c_out,), generator=g) * 0.1).to(device)
    return p


def baseline(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return layers.conv3d(p, x[None], relu=True)[0]


def conv9gemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              relu: bool = True) -> torch.Tensor:
    """SAME 3x3x3 conv of one (z, y, x, c) volume as nine shifted-view
    matmuls with the three z-taps packed into K (K = 3 * c_in)."""
    return ladder.ladder_conv9view_bias_relu_plain(x, ladder.pack_w9(w), b,
                                                   relu)


def make_copad(p: Dict[str, torch.Tensor], co_pad: int
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The baseline with c_out zero-padded to ``co_pad``, sliced back."""
    co = p["w"].shape[-1]
    pp = {"w": F.pad(p["w"], (0, co_pad - co)).contiguous(),
          "b": F.pad(p["b"], (0, co_pad - co))}
    return lambda x: baseline(pp, x)[..., :co]


def _maxerr(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max())


def _tol(ref: torch.Tensor) -> float:
    return CONV_RTOL * float(ref.abs().max()) + CONV_ATOL


def _hold(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max error {err} > {tol}")


def width_record(x: torch.Tensor, p: Dict[str, torch.Tensor],
                 ladder_width: bool, on_card: bool) -> dict:
    """One width's record: conv9gemm, cuDNN and the bound; at the ladder's
    width the padded-c_out baselines, elsewhere the baseline and the
    nine-view kernel."""
    co = p["w"].shape[-1]
    flop = conv_flop(x, co)
    rec: dict = {"gflop": flop / 1e9}
    ref = hopper_conv.conv3x3x3_bias_relu_plain(x, p["w"], p["b"])
    tol = _tol(ref)
    cands = {"gemm9": (lambda: conv9gemm(x, p["w"], p["b"]), "tflops")}
    if ladder_width:
        for cop in (2 * co, 4 * co):
            cands[f"copad{cop}"] = (functools.partial(make_copad(p, cop), x),
                                    "eff_tflops")
    else:
        w9 = ladder.pack_w9(p["w"])
        cands["baseline"] = (lambda: baseline(p, x), "tflops")
        cands["conv9view"] = (lambda: ladder.ladder_conv9view_bias_relu(
            x, w9, p["b"]), "tflops")
    for name, (fn, rate) in cands.items():
        err = _maxerr(fn(), ref)
        _hold(f"{name} c{x.shape[-1]}->c{co}", err, tol)
        rec[f"{name}_maxerr"] = err
        if on_card:
            ms = timed(fn)
            rec[f"{name}_ms"] = ms
            rec[f"{name}_{rate}"] = flop / ms / 1e9
    if on_card and "conv9view" in cands:
        rec["conv9view_device_ms"] = device_ms(cands["conv9view"][0],
                                               C_KERNEL)
    if on_card:
        ms = timed(lambda: library_conv(x, p["w"], p["b"]))
        rec["library_ms"] = ms
        rec["library_tflops"] = flop / ms / 1e9
        rec["bound_ms"], rec["bound_by"] = conv_bound(x, p["w"], p["b"])
        rec["tc_bound_ms"] = conv_tc_bound(x, p["w"], p["b"])[0]
    return rec


def ladder_entry(kernel: Callable[[], torch.Tensor],
                 plain: Callable[[], torch.Tensor],
                 library_ms: Optional[float], flop: float, moved: int,
                 exact: bool, on_card: bool, name: str,
                 device_name: Optional[str] = None) -> dict:
    """Run, check and (on the card) time one ladder kernel;
    ``library_ms`` is its library call's reading (None off the card, or
    where there is none); ``device_name`` names the CUDA kernel whose
    device time the record carries as ``device_ms``."""
    got, ref = kernel(), plain()
    err = _maxerr(got, ref)
    tol = 0.0 if exact else _tol(ref)
    _hold(name, err, tol)
    rec = {"ok": True, "maxerr": err, "tol": tol, "flop": flop,
           "bytes": moved}
    if on_card:
        ms = timed(kernel)
        b_ms, b_by = bound(flop, moved)
        rec.update(ms=ms, tflops=flop / ms / 1e9, bound_ms=b_ms,
                   bound_by=b_by, plain_ms=timed(plain),
                   library_ms=library_ms)
        if device_name is not None:
            rec["device_ms"] = device_ms(kernel, device_name)
    return rec


def pallas_ladder(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  results: dict, on_card: bool) -> None:
    """The ladder on the first width's ``x`` and ``p``; a kernel that fails
    to build, to launch or to match its plain version raises."""
    ci = x.shape[-1]
    co = p["w"].shape[-1]
    m = x.numel() // ci

    def lib_ms(fn: Callable[[], object]) -> Optional[float]:
        return timed(fn) if on_card else None

    results["pallas_A_passthrough"] = a = ladder_entry(
        lambda: ladder.ladder_add_one(x),
        lambda: ladder.ladder_add_one_plain(x), lib_ms(lambda: x + 1.0),
        float(x.numel()), 2 * nbytes(x), True, on_card, "A add_one",
        A_KERNEL)
    if on_card:
        a["library_device_ms"] = device_ms(lambda: x + 1.0, A_LIBRARY_KERNEL)

    w1 = torch.from_numpy(np.random.RandomState(1).rand(ci, co).astype(
        np.float32)).to(x.device)
    mm_flop = 2.0 * m * ci * co
    mm_bytes = nbytes(x, w1) + m * co * 4
    mm_ms = lib_ms(lambda: torch.matmul(x.view(m, ci), w1))
    for key in ("pallas_B_dotgeneral", "pallas_B2_reshape_dot"):
        results[key] = ladder_entry(
            lambda: ladder.ladder_pointwise_matmul(x, w1),
            lambda: ladder.ladder_pointwise_matmul_plain(x, w1), mm_ms,
            mm_flop, mm_bytes, False, on_card, f"{key} pointwise_matmul",
            B_KERNEL)

    # C and E compute the width record's conv; w9 holds w's numbers in
    # another order
    w9 = ladder.pack_w9(p["w"])
    c_flop = conv_flop(x, co)
    c_bytes = nbytes(x, p["w"], p["b"]) + m * co * 4
    conv_ms = results[f"c{ci}_to_c{co}"].get("library_ms")
    results["pallas_C_9view_conv"] = ladder_entry(
        lambda: ladder.ladder_conv9view_bias_relu(x, w9, p["b"]),
        lambda: ladder.ladder_conv9view_bias_relu_plain(x, w9, p["b"]),
        conv_ms, c_flop, c_bytes, False, on_card, "C conv9view", C_KERNEL)
    results["pallas_E_manual_dma"] = ladder_entry(
        lambda: hopper_conv.conv3x3x3_bias_relu(x, p["w"], p["b"]),
        lambda: hopper_conv.conv3x3x3_bias_relu_plain(x, p["w"], p["b"]),
        conv_ms, c_flop, c_bytes, False, on_card, "E conv3x3x3")
    if on_card:
        # C and E run on the tensor cores: their bound is three TF32 passes
        for key in ("pallas_C_9view_conv", "pallas_E_manual_dma"):
            e = results[key]
            e["f32_bound_ms"] = e["bound_ms"]
            e["bound_ms"], e["bound_by"] = conv_tc_bound(x, p["w"], p["b"])


def run(device=None, shape: Sequence[int] = SHAPE, c_in: int = C_IN,
        c_outs: Sequence[int] = C_OUTS) -> dict:
    """The probe on ``device`` (``None``: the card).  Records are keyed
    ``c{c_in}_to_c{c_out}``; the copad variants and the ladder run at the
    first width."""
    dev = select_device(device)
    on_card = dev.type == "cuda"
    rng = np.random.RandomState(0)
    z, y, xl = (int(s) for s in shape)
    results: dict = {"shape": [z, y, xl]}
    first = None
    for i, co in enumerate(c_outs):
        p = init_conv(c_in, co, 0, dev)
        x = torch.from_numpy(rng.rand(z, y, xl, c_in).astype(
            np.float32)).to(dev)
        results[f"c{c_in}_to_c{co}"] = width_record(x, p, i == 0, on_card)
        first = first or (x, p)
    pallas_ladder(*first, results, on_card)
    if on_card:
        torch.cuda.synchronize()
        results["device"] = torch.cuda.get_device_name(dev)
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON here (e.g. under chiprun_out/)")
    args = ap.parse_args(argv)
    results = run()
    for key, rec in results.items():
        print(key, json.dumps(rec), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=2))
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
