"""The JAX package's default bfloat16 compute dtype in the port, on the CPU.

JAX's ``layers.conv3d`` / ``dense`` with ``compute_dtype=jnp.bfloat16``
(``models/layers.py:50-60``, ``:120-126``) round the input and the weights
to bf16 and keep the products, sums, bias and output in f32.  A product of
two bf16 values is exact in f32, so the port's layer agrees with JAX's up
to f32 summation order: every layer is held to ``TOL`` of ``sum |x w| +
|b|`` (the sum of the magnitudes of the rounded terms).  Three planted
faults (the output rounded, the bias rounded, the weights left unrounded)
each miss that bound.  The whole network is chaotic (each layer rounds its
input again), so U-Net a and the bench StarDist in both archs are held
layer by layer on JAX's own input to each layer (teacher forcing); the
whole network only statistically, against JAX's own spread, by the records
(``assets/legacy/jax_legacy_record_bf16*.npz``, tests/
test_torch_legacy_record.py).  ``emulate_bf16`` repeats the bf16 form of
the tensor-core kernel's arithmetic (``csrc/conv3x3x3_wgmma_bf16.cu``: stages,
taps, k16 columns, the packed weights read through the core-matrix layout,
per-stage partial sums)."""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import t3dct_torch  # noqa: F401
from t3dct.config import StarDistConfig as JSDConfig
from t3dct.engine import legacy as jlegacy
from t3dct.engine.segmentation import UNetSegmenter as JSegmenter
from t3dct.models import layers as JL
from t3dct.models.stardist3d import StarDist3DNet as JNet
from t3dct.models.unet3d import unet3_a as junet3_a
from t3dct_torch.config import SegmentationConfig, StarDistConfig
from t3dct_torch.engine import legacy
from t3dct_torch.engine.segmentation import UNetSegmenter
from t3dct_torch.models import layers as L
from t3dct_torch.models.stardist3d import StarDist3DNet
from t3dct_torch.models.unet3d import UNet3D, unet3_a
from t3dct_torch.ops import hopper_conv as hc
from t3dct_torch.utils.checkpoint import load_pytree

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_legacy import (MAX_CELLS, SEG, SHAPE, UNET,  # noqa: E402
                               Z_SCALING, Z_XY_RATIO, to_jax)

BF16 = torch.bfloat16
# f32 summation order: a layer's outputs agree within TOL of sum |x w| + |b|
TOL = 1e-6
LEGACY = Path(__file__).resolve().parents[1] / "3deecelltracker_tpu_torch" / \
    "assets" / "legacy"
# every listed input width, 3x3x3 and 1x1x1, with a c_out of the paths
WIDTHS = [(1, 8), (8, 16), (16, 32), (64, 64), (128, 32)]
CASE_SHAPE = (1, 5, 10, 12)
BENCH_SD = dict(n_rays=96, grid=(1, 2, 2), anisotropy=(9.2, 1.0, 1.0),
                unet_n_filter_base=32, net_conv_after_unet=128)


def case(c_in, c_out, k=3, seed=0):
    """x as the layers see it (ReLU'd; signed for a stem), glorot-scale
    weights, a bias of the scale of a trained one."""
    rng = np.random.RandomState(seed + 3 * c_in + 11 * c_out + k)
    x = rng.randn(*CASE_SHAPE, c_in).astype(np.float32)
    if c_in > 1:
        x = np.maximum(x, 0)
    lim = np.sqrt(6.0 / (k ** 3 * (c_in + c_out)))
    w = rng.uniform(-lim, lim, (k, k, k, c_in, c_out)).astype(np.float32)
    b = (rng.randn(c_out) * 0.1).astype(np.float32)
    return x, w, b


def conv(x, w, b, round_x=True, round_w=True):
    """An f32 SAME conv + b of ``x`` with ``w`` (DHWIO, 3^3 or 1^1),
    each operand rounded to bf16 where asked: the plain bf16 conv and its
    planted faults."""
    x = hc.round_bf16(x) if round_x else x
    w = hc.round_bf16(w) if round_w else w
    if w.shape[0] == 1:
        return x @ w.reshape(w.shape[3], w.shape[4]) + b
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1) + b


def scale(x, w, b):
    """sum |x w| over each output's terms, + |b|."""
    return conv(x.abs(), w.abs(), b.abs())


def departure(got, want, s):
    """The largest ``|got - want| / s``: within f32 summation order when
    at most ``TOL``."""
    got, want, s = (np.asarray(a, np.float64) for a in (got, want, s))
    return float((np.abs(got - want) / s).max())


def jax_conv(x, w, b):
    return np.asarray(JL.conv3d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x), jnp.bfloat16))


FAULTS = {
    "output rounded": lambda x, w, b: hc.round_bf16(conv(x, w, b)),
    "bias rounded": lambda x, w, b: conv(x, w, hc.round_bf16(b)),
    "weights unrounded": lambda x, w, b: conv(x, w, b, round_w=False),
}


# ---- one layer ---------------------------------------------------------

@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("c_in,c_out", WIDTHS)
def test_conv3d_matches_jax_bf16(c_in, c_out, k):
    """``layers.conv3d(p, x, torch.bfloat16)`` against JAX's with
    ``jnp.bfloat16`` on the same f32 input: f32 out, within ``TOL``."""
    x, w, b = case(c_in, c_out, k)
    want = jax_conv(x, w, b)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = L.conv3d({"w": tw, "b": tb}, tx, BF16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert departure(got, want, scale(tx, tw, tb)) <= TOL
    # and not the f32 layer: the rounding is there to see
    f32 = L.conv3d({"w": tw, "b": tb}, tx)
    assert departure(f32, want, scale(tx, tw, tb)) > 10 * TOL


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("c_in,c_out,k", [(1, 8, 3), (16, 32, 3),
                                          (128, 32, 3), (128, 32, 1)])
def test_planted_faults_miss_the_bound(fault, c_in, c_out, k):
    """Each planted fault departs from JAX's bf16 layer by more than
    ``TOL``, while the plain bf16 conv stays within it."""
    x, w, b = case(c_in, c_out, k)
    want = jax_conv(x, w, b)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    s = scale(tx, tw, tb)
    assert departure(conv(tx, tw, tb), want, s) <= TOL
    assert departure(FAULTS[fault](tx, tw, tb), want, s) > 3 * TOL


@pytest.mark.parametrize("d_in,d_out", [(8, 16), (64, 1), (128, 32)])
def test_dense_matches_jax_bf16(d_in, d_out):
    rng = np.random.RandomState(d_in + d_out)
    x = rng.randn(7, d_in).astype(np.float32)
    w = (rng.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)
    b = rng.randn(d_out).astype(np.float32)
    want = np.asarray(JL.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x), jnp.bfloat16))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = L.dense({"w": tw, "b": tb}, tx, BF16)
    s = (hc.round_bf16(tx).abs() @ hc.round_bf16(tw).abs()) + tb.abs()
    assert got.dtype == torch.float32
    assert departure(got, want, s) <= TOL
    assert departure(L.dense({"w": tw, "b": tb}, tx), want, s) > 10 * TOL


def test_compute_dtype_is_checked():
    x, w, b = (torch.from_numpy(a) for a in case(8, 16))
    with pytest.raises(TypeError):
        L.conv3d({"w": w, "b": b}, x, torch.float16)
    with pytest.raises(TypeError):
        hc.route(8, 16, torch.float64)


# ---- the bf16 form of the tensor-core kernel, emulated --------------------

def b_matrix_bf16(flat, nb):
    """The (16 k, nb n) matrix a k16 wgmma B descriptor reads from
    ``flat`` (the 16-bit core-matrix layout)."""
    k = torch.arange(16)[:, None]
    n = torch.arange(nb)[None, :]
    return flat[((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8]


def emulate_bf16(x, w, b):
    """The bf16 form's arithmetic on one (z, y, x, c_in) volume: stage
    (16-channel chunk, dz), tap (dy, dx), column k = channel k of the
    chunk (zero past c_in), A rounded to bf16, B read from the packed
    weights; each stage's partial sum added to the total in f32, then the
    bias."""
    z, y, xl, c_in = x.shape
    c_out = w.shape[4]
    packed, nb = hc.pack_weights_bf16(w)
    assert packed.dtype == BF16
    kc = -(-c_in // hc.CK_BF16)
    xp = F.pad(x, (0, kc * hc.CK_BF16 - c_in, 1, 1, 1, 1, 1, 1))
    out = []
    for nc in range(packed.shape[0]):
        total = torch.zeros((z * y * xl, nb))
        for s in range(packed.shape[1]):
            chunk, dz = divmod(s, 3)
            part = torch.zeros_like(total)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a = xp[dz:dz + z, dy:dy + y, dx:dx + xl,
                       16 * chunk:16 * chunk + 16].reshape(-1, 16)
                part += hc.round_bf16(a) @ b_matrix_bf16(
                    packed[nc, s, tap], nb).float()
            total += part
        out.append(total)
    return torch.cat(out, dim=1)[:, :c_out].reshape(z, y, xl, c_out) + b


@pytest.mark.parametrize("c_in,c_out", [(8, 16), (24, 8), (16, 32),
                                        (128, 32), (32, 136)])
def test_bf16_emulation_matches_plain(c_in, c_out):
    """Half chunks (c_in % 16 == 8), several N tiles (c_out 136): the
    emulated kernel holds the plain bf16 version within ``TOL``."""
    x, w, b = (torch.from_numpy(a) for a in case(c_in, c_out))
    got = emulate_bf16(x[0], w, b)
    want = hc.conv3x3x3_bias_relu_plain(x[0], w, b, relu=False,
                                        compute_dtype=BF16)
    assert departure(got, want, scale(x, w, b)[0]) <= TOL


@pytest.mark.parametrize("c_in,c_out", [(8, 16), (24, 136)])
def test_bf16_packing(c_in, c_out):
    """Shape, zero padding and rounding (ties to even) of the packed
    weights; element (k, n) of tap (dz, dy, dx), chunk c and N tile nc
    holds channel 16 c + k."""
    w = torch.from_numpy(case(c_in, c_out)[1])
    packed, nb = hc.pack_weights_bf16(w)
    kc = -(-c_in // 16)
    n_chunks = -(-c_out // nb)
    assert nb == hc.n_tile(c_out)
    assert packed.shape == (n_chunks, 3 * kc, 9, 16 * nb)
    assert packed.is_contiguous()
    wr = w.to(BF16)
    rng = np.random.RandomState(0)
    for _ in range(300):
        nc, c, dz, dy, dx, k = (rng.randint(m) for m in
                                (n_chunks, kc, 3, 3, 3, 16))
        n = rng.randint(nb)
        ci, co = 16 * c + k, nc * nb + n
        want = 0.0 if ci >= c_in or co >= c_out else float(
            wr[dz, dy, dx, ci, co])
        got = packed[nc, 3 * c + dz, 3 * dy + dx,
                     ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8]
        assert float(got) == want
    # round to nearest, ties to even
    v = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -20])
    assert hc.round_bf16(v).tolist() == [1.0, 1 + 2 ** -6, 1 + 2 ** -7]


def test_bf16_routing_and_cache():
    """bf16 layers route to the bf16 forms by the same width rule; the
    bf16 packing is cached beside the TF32 one, apart from it."""
    assert hc.route(8, 16, BF16) == "wgmma_bf16"
    assert hc.route(1, 8, BF16) == "direct_bf16"
    assert hc.route(1, 8) == "direct" and hc.route(8, 16) == "wgmma"
    w = torch.from_numpy(case(8, 16)[1])
    p16, _ = hc.packed_weights(w, bf16=True)
    assert hc.packed_weights(w, bf16=True)[0] is p16
    assert hc.packed_weights(w)[0].dtype == torch.float32
    assert hc.packed_weights(w, bf16=True)[0] is p16


def test_bf16_wrappers_run_plain_on_cpu():
    """On CPU tensors the two bf16 wrappers run the plain bf16 version and
    count no launch."""
    before = [k.launches for k in hc.KERNELS]
    for c_in, fn in ((1, hc.conv3x3x3_direct_bf16),
                     (16, hc.conv3x3x3_wgmma_bf16)):
        x, w, b = (torch.from_numpy(a) for a in case(c_in, 8))
        want = hc.conv3x3x3_bias_relu_plain(x, w, b, True, BF16)
        assert torch.equal(fn(x, w, b), want)
        assert torch.equal(hc.conv3x3x3_bias_relu(
            x, w, b, compute_dtype=BF16), want)
    assert [k.launches for k in hc.KERNELS] == before
    assert len(hc.KERNELS) == 4


def test_bf16_backward_raises():
    """No JAX trainer differentiates a bf16 conv: the port's bf16 Function
    raises in backward, naming the ROADMAP item, and falls back to
    nothing."""
    x, w, b = (torch.from_numpy(a) for a in case(8, 16))
    x.requires_grad_(True)
    y = L.conv3d({"w": w, "b": b}, x, BF16, relu=True)
    with pytest.raises(NotImplementedError, match="A.4"):
        y.sum().backward()
    assert x.grad is None
    y = L.conv3d({"w": w, "b": b}, x, relu=True)
    y.sum().backward()
    assert x.grad is not None


# ---- the networks, teacher-forced ----------------------------------------

def record_jax_convs(monkeypatch):
    """Patch JAX's ``layers.conv3d`` to record (params, input, output) of
    every call."""
    calls = []
    orig = JL.conv3d

    def recorded(params, x, compute_dtype=jnp.float32):
        y = orig(params, x, compute_dtype)
        calls.append((params, np.array(x), np.array(y), compute_dtype))
        return y
    monkeypatch.setattr(JL, "conv3d", recorded)
    return calls


def hold_layers(calls, names, port_params):
    """Each recorded JAX layer's input through the port's layer: within
    ``TOL`` of JAX's output.  Returns the layers held, in order."""
    held = []
    for params, x, y, dtype in calls:
        assert dtype == jnp.bfloat16
        name = names[id(params)]
        p = port_params(name)
        tx = torch.from_numpy(x)
        got = L.conv3d(p, tx, BF16)
        dep = departure(got, y, scale(tx, p["w"], p["b"]))
        assert dep <= TOL, (name, dep)
        held.append(name)
    return held


def test_unet_a_teacher_forced(monkeypatch):
    """U-Net a with the committed trained weights: every conv block and
    the output conv, fed JAX's own bf16 input to it."""
    spec = unet3_a()
    params, state = load_pytree(
        spec.init(torch.Generator().manual_seed(0), device="cpu"),
        LEGACY / "unet3_a.npz")
    jparams, jstate = to_jax(params), to_jax(state)
    names = {id(jparams[n]["conv"]): n for n in jparams}
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 24, 24, 4, 1) * 2).astype(np.float32)
    calls = record_jax_convs(monkeypatch)
    jprobs, _ = junet3_a().apply(jparams, jstate, jnp.asarray(x),
                                 compute_dtype=jnp.bfloat16)
    held = hold_layers(calls, names, lambda n: params[n]["conv"])
    assert held == [n for n, _, _ in spec.block_plan()[0]] + ["out"]
    probs = spec.apply(params, state, torch.from_numpy(x),
                       compute_dtype=BF16)
    assert probs.dtype == torch.float32 and probs.shape == jprobs.shape
    assert torch.isfinite(probs).all()


@pytest.mark.parametrize("arch", ["tpu", "keras"])
def test_stardist_teacher_forced(monkeypatch, arch):
    """The bench StarDist's widths in both archs (seeded weights): every
    conv fed JAX's own bf16 input to it."""
    net = StarDist3DNet(StarDistConfig(**BENCH_SD), arch)
    params = net.init(torch.Generator().manual_seed(3), device="cpu")
    jparams = to_jax(params)
    names = {id(p): n for n, p in jparams.items()}
    rng = np.random.RandomState(6)
    x = np.abs(rng.randn(1, 4, 16, 16, 1)).astype(np.float32)
    calls = record_jax_convs(monkeypatch)
    jnet = JNet(JSDConfig(**BENCH_SD), arch=arch)
    jprob, jdist = jnet.apply(jparams, jnp.asarray(x), jnp.bfloat16)
    held = hold_layers(calls, names, lambda n: params[n])
    assert held == [n for n, *_ in net.conv_plan()]
    prob, dist = net.apply(params, torch.from_numpy(x), BF16)
    assert prob.shape == jprob.shape and dist.shape == jdist.shape
    assert prob.dtype == dist.dtype == torch.float32


# ---- JAX's default, in the segmenter and the Tracker ------------------------

def small_unet():
    spec = UNet3D(**UNET)
    params, state = spec.init(torch.Generator().manual_seed(0),
                              device="cpu")
    return spec, params, state


def test_segmenter_defaults_to_bf16():
    """``UNetSegmenter`` defaults to bfloat16 as JAX's does, and its U-Net
    computes in it: its probabilities are the bf16 network's."""
    spec, params, state = small_unet()
    seg = UNetSegmenter(spec, params, state, SegmentationConfig(**SEG), SHAPE,
                        max_cells=MAX_CELLS, device="cpu")
    assert seg.compute_dtype == BF16
    from t3dct.config import SegmentationConfig as JSegConfig
    from t3dct.models.unet3d import UNet3D as JUNet3D
    jseg = JSegmenter(JUNet3D(**UNET), to_jax(params), to_jax(state),
                      JSegConfig(**SEG), SHAPE, max_cells=MAX_CELLS)
    assert jseg.compute_dtype == jnp.bfloat16
    raw = np.random.RandomState(2).rand(*SHAPE).astype(np.float32) * 400
    got = seg.predict_cellregions(raw)
    f32 = UNetSegmenter(spec, params, state, SegmentationConfig(**SEG),
                        SHAPE, max_cells=MAX_CELLS,
                        compute_dtype=torch.float32, device="cpu")
    assert not torch.equal(got, f32.predict_cellregions(raw))


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(mesh_mode="halo"),
                                dict(spatial_axis="x"), dict(halo=4)])
def test_segmenter_mesh_raises(kw):
    """A mesh that is no ``DeviceMesh`` raises ``TypeError``; without a
    mesh, ``mesh_mode``, ``spatial_axis`` and ``halo`` are ignored, as in
    JAX: the segmenter is the one-card tile sweep (its probabilities equal
    the default segmenter's).  The mesh runs are
    ``tests/test_torch_mesh_unet.py``."""
    spec, params, state = small_unet()
    if "mesh" in kw:
        with pytest.raises(TypeError, match="DeviceMesh"):
            UNetSegmenter(spec, params, state, SegmentationConfig(**SEG),
                          SHAPE, device="cpu", **kw)
        return
    raw = np.random.RandomState(3).rand(*SHAPE).astype(np.float32) * 400
    seg = UNetSegmenter(spec, params, state, SegmentationConfig(**SEG),
                        SHAPE, max_cells=MAX_CELLS, device="cpu", **kw)
    plain = UNetSegmenter(spec, params, state, SegmentationConfig(**SEG),
                          SHAPE, max_cells=MAX_CELLS, device="cpu")
    assert seg.mesh is None
    assert torch.equal(seg.predict_cellregions(raw),
                       plain.predict_cellregions(raw))


def test_tracker_builds_jax_default(tmp_path):
    """The port's ``Tracker`` builds a bfloat16 segmenter, as JAX's
    ``Tracker`` does (no knob in either); ``legacy_segment_and_track_
    arrays`` follows by default."""
    spec, params, state = small_unet()
    args = (2, SHAPE, Z_XY_RATIO, Z_SCALING, 20, 20, 50.0, 0.1, 10)
    pt = legacy.Tracker(*args, str(tmp_path / "port"), "raw_t%03i_z%03i.tif",
                        "unet.npz", "ffn.npz", shrink=SEG["shrink"],
                        device="cpu")
    pt.load_unet_arrays(spec, params, state)
    assert pt.segmenter.compute_dtype == BF16
    from t3dct.models.unet3d import UNet3D as JUNet3D
    jt = jlegacy.Tracker(*args, str(tmp_path / "jax"), "raw_t%03i_z%03i.tif",
                         "unet.npz", "ffn.npz", shrink=SEG["shrink"])
    jt.load_unet_arrays(JUNet3D(**UNET), to_jax(params), to_jax(state))
    assert jt.segmenter.compute_dtype == jnp.bfloat16
    import inspect
    sig = inspect.signature(legacy.legacy_segment_and_track_arrays)
    assert sig.parameters["compute_dtype"].default == BF16
    assert "compute_dtype" not in inspect.signature(legacy.Tracker).parameters


# ---- the bf16 records ------------------------------------------------------

RECORDS = {"jax_legacy_record_bf16.npz": {},
           "jax_legacy_record_ensemble_bf16.npz": dict(ensemble=20),
           "jax_legacy_record_bf16_nudged.npz": dict(nudge_seed=1),
           **{f"jax_legacy_record_bf16_nudged_s{s}.npz": dict(nudge_seed=s)
              for s in range(2, 13)}}


@pytest.fixture(scope="module")
def bf16_records():
    out = {}
    for name in RECORDS:
        with np.load(LEGACY / name) as data:
            out[name] = {k: data[k] for k in data.files}
    return out


def test_bf16_records_hold_their_recipe(bf16_records):
    """JAX's own ``Tracker`` at its default precision over the 21-volume
    bench folder with the example's defaults and the committed U-Net a,
    single mode, ensemble 20, and single mode with the weights nudged by
    one ulp (twelve seeds); vol 1's cached probabilities in JAX's float16
    beside the single record and the first nudged run."""
    f32 = np.load(LEGACY / "jax_legacy_record.npz")
    f32_recipe = json.loads(str(f32["recipe"]))
    for name, kw in RECORDS.items():
        rec = bf16_records[name]
        recipe = json.loads(str(rec["recipe"]))
        assert str(rec["compute_dtype"]) == "bfloat16"
        for key in ("example", "max_cells", "n_vols", "weights",
                    "image_name"):
            assert recipe[key] == f32_recipe[key], (name, key)
        for key, v in kw.items():
            assert recipe[key] == v
        n = recipe["n_vols"]
        assert rec["cells"].shape == (n,) and rec["cells"].min() > 0
        assert rec["auto_vol1"].shape == f32["auto_vol1"].shape
        for t in range(1, n + 1):
            assert rec[f"coords_{t}"].shape == f32[f"coords_{t}"].shape
            assert np.isfinite(rec[f"coords_{t}"]).all()
            assert rec[f"labels_{t}"].shape == f32[f"labels_{t}"].shape
        if kw in ({}, dict(nudge_seed=1)):
            assert rec["prob_1"].dtype == np.float16
            assert rec["prob_1"].shape == f32["auto_vol1"].shape
    # the precision shows in what JAX computed
    base = bf16_records["jax_legacy_record_bf16.npz"]
    assert not np.array_equal(base["auto_vol1"], f32["auto_vol1"])
    nudged = bf16_records["jax_legacy_record_bf16_nudged.npz"]
    assert not np.array_equal(base["prob_1"], nudged["prob_1"])


def test_phase23_holds_at_twice_jax_spread(bf16_records):
    """``chip_smoke.hold_legacy_bf16``, phase 23's rule: every nudged run
    of JAX's holds (it lies within JAX's spread by definition); a run one
    identity switch, or one volume's cell count, past twice the spread
    fails, and so do coordinates that are not finite."""
    sys.path.insert(0, str(LEGACY.parents[1]))
    import chip_smoke
    names = [n for n, kw in RECORDS.items() if "nudge_seed" in kw]
    assert chip_smoke.LEG_BF16_SPREAD == tuple(names)
    single = bf16_records["jax_legacy_record_bf16.npz"]
    nudged = [bf16_records[n] for n in names]
    spread = chip_smoke.jax_spread(single, nudged)

    def run_of(rec, **metrics):
        m = dict(json.loads(str(rec["metrics"])), **metrics)
        return dict(rec, metrics=m)
    for rec in nudged:
        assert chip_smoke.hold_legacy_bf16(
            "nudged", single, single, nudged, run_of(rec))[0] == []
    m = json.loads(str(single["metrics"]))
    bad, _ = chip_smoke.hold_legacy_bf16("planted", single, single, nudged,
                                         run_of(single, id_switches=(
                                             m["id_switches"] +
                                             2 * spread["switches"] + 1)))
    assert [b.split()[0] for b in bad] == ["switches"]
    cells = single["cells"].copy()
    cells[3] += 2 * spread["cells_max"] + 1
    bad, _ = chip_smoke.hold_legacy_bf16("planted", single, single, nudged,
                                         dict(run_of(single), cells=cells))
    assert [b.split()[0] for b in bad] == ["cells_max"]
    coords = single["coords_5"].copy()
    coords[7, 1] = np.nan
    bad, _ = chip_smoke.hold_legacy_bf16("planted", single, single, nudged,
                                         dict(run_of(single), coords_5=coords))
    assert "coordinates not finite" in bad


def prob_departure(got, want):
    """(max |d|, its 99.9th percentile, voxels on the other side of 0.5)
    of two float16 probability maps."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    d = np.abs(got - want)
    return (float(d.max()), float(np.percentile(d, 99.9)),
            int(((got > 0.5) != (want > 0.5)).sum()))


def test_port_vol1_probs_within_jax_spread(bf16_records):
    """The port's bf16 U-Net a on vol 1 of the bench scene, on the CPU,
    against JAX's bf16 record, in the cache's float16: max and 99.9th
    percentile difference and the voxels across 0.5 each within twice
    JAX's own spread (its run with the weights nudged by one ulp)."""
    from test_torch_legacy_record import EXAMPLE, SHAPE_XYZ, scene
    base = bf16_records["jax_legacy_record_bf16.npz"]["prob_1"]
    spread = prob_departure(
        bf16_records["jax_legacy_record_bf16_nudged.npz"]["prob_1"], base)
    spec = unet3_a()
    params, state = load_pytree(
        spec.init(torch.Generator().manual_seed(0), device="cpu"),
        LEGACY / "unet3_a.npz")
    seg = UNetSegmenter(spec, params, state, SegmentationConfig(
        noise_level=EXAMPLE["noise_level"]), SHAPE_XYZ, device="cpu")
    vol1 = scene()[0][0]
    got = seg.predict_cellregions(vol1).numpy().astype(np.float16)
    dep = prob_departure(got, base)
    assert all(d <= 2 * s for d, s in zip(dep, spread)), (dep, spread)
