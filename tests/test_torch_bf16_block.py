"""The legacy U-Net's bf16 block (conv, activation, eval-mode BatchNorm,
stored in bf16) and the bf16 ``UNet3D.apply`` that runs on it, on the CPU.

JAX's block is ``conv3d(x, compute_dtype=bfloat16)`` -> activation ->
``batchnorm(train=False)`` in f32 (``models/unet3d.py:88-92``), and its next
conv rounds that output to bf16 again.  The port's block
(``models/layers.py::conv_block_bf16``, ``ops/hopper_conv.py::
conv3x3x3_block_bf16``, plain version on the CPU) stores exactly that
rounding.  Against JAX, every output equals JAX's bf16 value or its bf16
neighbour, a neighbour only where JAX's f32 value lies within ``TOL`` of
sum |x w| + |b| (times |inv|, plus ``ULPS`` of the value for the f32
roundings of BatchNorm's three operations) of a rounding midpoint (and
more than one step only where that bound spans more steps: values that
BatchNorm's subtraction leaves near 0).  Against
the port's own unfused composition it is bit-equal, and so is the whole
bf16 ``UNet3D.apply`` against the composition of ``layers.conv3d``, the
activation and ``layers.batchnorm`` on f32 tensors: storing bf16 changes
nothing, since rounding to nearest commutes with max-pooling, nearest
upsampling and concatenation.  Shapes: U-Net a and b on (16, 16, 4)
tiles, c on (16, 16, 8), every block of each."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.models import layers as JL
from t3dct_torch.models import layers as L
from t3dct_torch.models.unet3d import get_unet
from t3dct_torch.ops import hopper_conv as hc

BF16 = torch.bfloat16
# f32 summation order (the bound of tests/test_torch_bf16.py's layers at
# the card's BF16_RTOL): a block's f32 value within TOL of sum |x w| + |b|,
# times |inv|, and ULPS of itself for BatchNorm's roundings
TOL = 1e-5
ULPS = 2.0 ** -21
TILES = {"a": (16, 16, 4), "b": (16, 16, 4), "c": (16, 16, 8)}
BATCH = 2


def spec_of(variant):
    return dataclasses.replace(get_unet(variant), tile_shape=TILES[variant])


def block_cases():
    """``(variant, name, spatial shape, c_in, c_out, activation)`` of every
    conv block of U-Net a, b and c on their small tiles: down level l on
    the tile pooled l times, up level i on the tile pooled depth - i
    times, the head on the whole tile."""
    out = []
    for variant in "abc":
        spec = spec_of(variant)
        depth = len(spec.down_filters)
        plan, _ = spec.block_plan()
        for name, ci, co in plan:
            level = (int(name[4]) if name.startswith("down") else
                     depth - int(name[2]) if name.startswith("up") else 0)
            shape = tuple(t // p ** level
                          for t, p in zip(spec.tile_shape, spec.pool))
            out.append((variant, name, shape, ci, co, spec.activation))
    return out


CASES = block_cases()
IDS = [f"{v}-{n}" for v, n, *_ in CASES]


def block_inputs(shape, ci, co, seed):
    """A block's input as the network hands it on (the f32 LCN tile for a
    stem, else ReLU'd values already rounded to bf16), glorot weights, a
    bias, and BatchNorm parameters and statistics that are not the
    identity, all f32 numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, *shape, ci).astype(np.float32)
    if ci > 1:
        x = hc.round_bf16(torch.from_numpy(np.maximum(x, 0))).numpy()
    lim = np.sqrt(6.0 / (27 * (ci + co)))
    w = rng.uniform(-lim, lim, (3, 3, 3, ci, co)).astype(np.float32)
    p = dict(b=rng.randn(co) * 0.1, mean=rng.randn(co) * 0.2,
             var=rng.rand(co) + 0.5, scale=rng.rand(co) + 0.5,
             beta=rng.randn(co) * 0.2)
    return x, w, {k: v.astype(np.float32) for k, v in p.items()}


def port_params(w, p):
    conv = {"w": torch.from_numpy(w), "b": torch.from_numpy(p["b"])}
    bn = {"scale": torch.from_numpy(p["scale"]),
          "bias": torch.from_numpy(p["beta"])}
    state = {"mean": torch.from_numpy(p["mean"]),
             "var": torch.from_numpy(p["var"])}
    return conv, bn, state


def port_input(x):
    """The port's block input: f32 for a stem, else the bf16 tensor."""
    t = torch.from_numpy(x)
    return t if x.shape[-1] == 1 else t.to(BF16)


def jax_block(x, w, p, act):
    """JAX's block in f32, before the next conv rounds it."""
    h = JL.conv3d({"w": jnp.asarray(w), "b": jnp.asarray(p["b"])},
                  jnp.asarray(x), jnp.bfloat16)
    h = JL.leaky_relu(h) if act == "leaky_relu" else jax.nn.relu(h)
    y, _ = JL.batchnorm({"scale": jnp.asarray(p["scale"]),
                         "bias": jnp.asarray(p["beta"])},
                        {"mean": jnp.asarray(p["mean"]),
                         "var": jnp.asarray(p["var"])}, h, False)
    return np.array(y, np.float32)


def ordered(t):
    """bf16 values as integers in the order of the values (+0 and -0
    alike), so neighbours differ by one."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


# ---- (a) the block against JAX's ----------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_block_matches_jax_bf16(case):
    """``layers.conv_block_bf16`` (the plain block on the CPU) against
    JAX's conv3d(bf16) -> activation -> batchnorm(train=False) ->
    astype(bfloat16): the rounding of a value within the bound of JAX's
    f32 value, so JAX's bf16 value wherever no rounding midpoint lies
    within the bound, its neighbour where one does."""
    variant, name, shape, ci, co, act = case
    x, w, p = block_inputs(shape, ci, co, CASES.index(case))
    v = jax_block(x, w, p, act)
    assert np.array_equal(np.asarray(jnp.asarray(v).astype(jnp.bfloat16),
                                     np.float32),
                          torch.from_numpy(v).to(BF16).float().numpy())
    conv, bn, state = port_params(w, p)
    got = L.conv_block_bf16(conv, bn, state, port_input(x), act)
    assert got.dtype == BF16 and got.shape == v.shape and \
        got.is_contiguous()
    assert within_jax(got, v, x, conv, bn, state)


def within_jax(got, v, x, conv, bn, state):
    """``got`` (bf16) is the rounding of a value within the bound of JAX's
    f32 block ``v``: between the roundings of ``v -+ eps``, so JAX's bf16
    value wherever no rounding midpoint lies within the bound, and no more
    bf16 steps from it than the bound spans elsewhere (one, but where a
    value near 0 after BatchNorm's subtraction has steps below it)."""
    inv = torch.rsqrt(state["var"] + L.BN_EPS) * bn["scale"]
    s = hc.conv3x3x3_bias_relu_plain(
        hc.round_bf16(torch.from_numpy(x)).abs(), hc.round_bf16(
            conv["w"]).abs(), conv["b"].abs(), False)
    tv = torch.from_numpy(v)
    eps = TOL * s * inv.abs() + ULPS * tv.abs()
    lo, hi = (tv - eps).to(BF16), (tv + eps).to(BF16)
    jb = tv.to(BF16)
    d = (ordered(got) - ordered(jb)).abs()
    return (bool((lo <= got).all()) and bool((got <= hi).all()) and
            torch.equal(got[lo == hi], jb[lo == hi]) and
            bool((d <= ordered(hi) - ordered(lo)).all()))


@pytest.mark.parametrize("fault", ["rounded before BatchNorm",
                                   "bias rounded", "weights unrounded"])
def test_planted_faults_miss_jax(fault):
    """``within_jax`` rejects a block that rounds before its BatchNorm,
    one that rounds its bias, and one that leaves its weights unrounded,
    on a wide layer of variant b; the plain block passes it there."""
    variant, name, shape, ci, co, act = next(
        c for c in CASES if c[0] == "b" and c[3] >= 128)
    x, w, p = block_inputs(shape, ci, co, 99)
    v = jax_block(x, w, p, act)
    conv, bn, state = port_params(w, p)
    inv = torch.rsqrt(state["var"] + L.BN_EPS) * bn["scale"]
    xt = port_input(x).float()
    if fault == "weights unrounded":
        y = hc.conv3x3x3_bias_relu_plain(hc.round_bf16(xt), conv["w"],
                                         conv["b"], False)
    else:
        b = hc.round_bf16(conv["b"]) if fault == "bias rounded" else \
            conv["b"]
        y = hc.conv3x3x3_bias_relu_plain(xt, conv["w"], b, False, BF16)
    y = hc.activation(y, act)
    if fault == "rounded before BatchNorm":
        y = y.to(BF16).float()
    bad = ((y - state["mean"]) * inv + bn["bias"]).to(BF16)
    assert within_jax(L.conv_block_bf16(conv, bn, state, port_input(x), act),
                      v, x, conv, bn, state)
    assert not within_jax(bad, v, x, conv, bn, state)


# ---- (b) the block against the port's unfused composition ---------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_block_equals_unfused(case):
    """The plain block is bit-equal to ``layers.conv3d(bf16)`` -> the
    activation -> ``layers.batchnorm`` -> ``.to(torch.bfloat16)``."""
    variant, name, shape, ci, co, act = case
    x, w, p = block_inputs(shape, ci, co, 1000 + CASES.index(case))
    conv, bn, state = port_params(w, p)
    xt = port_input(x)
    fn = L.leaky_relu if act == "leaky_relu" else torch.relu
    want = L.batchnorm(bn, state, fn(L.conv3d(conv, xt, BF16))).to(BF16)
    assert torch.equal(L.conv_block_bf16(conv, bn, state, xt, act), want)


# ---- (c) and (d): the whole network ---------------------------------------

def network(variant, seed):
    """A U-Net on its small tile with seeded glorot weights and BatchNorms
    that are not the identity, and a batch of f32 tiles."""
    spec = spec_of(variant)
    g = torch.Generator().manual_seed(seed)
    params, state = spec.init(g, device="cpu")
    for name in state:
        c = state[name]["mean"].shape[0]
        state[name] = {"mean": torch.randn(c, generator=g) * 0.2,
                       "var": torch.rand(c, generator=g) + 0.5}
        params[name]["bn"] = {"scale": torch.rand(c, generator=g) + 0.5,
                              "bias": torch.randn(c, generator=g) * 0.2}
        params[name]["conv"]["b"] = torch.randn(c, generator=g) * 0.1
    x = torch.randn((BATCH, *spec.tile_shape, 1), generator=g)
    return spec, params, state, x


def composed(spec, params, state, x, compute_dtype, train=False):
    """``UNet3D.apply`` as it was composed before the fused block: f32
    tensors between the layers, ``layers.conv3d`` in ``compute_dtype``,
    the activation and ``layers.batchnorm``."""
    act = L.leaky_relu if spec.activation == "leaky_relu" else torch.relu
    new_state = {}

    def block(name, h):
        h = act(L.conv3d(params[name]["conv"], h, compute_dtype))
        if not train:
            return L.batchnorm(params[name]["bn"], state[name], h)
        h, new_state[name] = L.batchnorm(params[name]["bn"], state[name], h,
                                         train=True)
        return h
    skips, h = [], x
    for lvl in range(len(spec.down_filters)):
        h = block(f"down{lvl}_1", block(f"down{lvl}_0", h))
        skips.append(h)
        h = L.max_pool3d(h, spec.pool)
    for i in range(len(spec.up_filters)):
        h = L.upsample3d(block(f"up{i}_1", block(f"up{i}_0", h)), spec.pool)
        h = torch.cat([h, skips[len(spec.up_filters) - 1 - i]], dim=-1)
    for i in range(len(spec.head_filters)):
        h = block(f"head{i}", h)
    probs = torch.sigmoid(L.conv3d(params["out"]["conv"], h, compute_dtype))
    return (probs, new_state) if train else probs


@pytest.mark.parametrize("variant", "abc")
def test_unet_bf16_equals_composition(variant, monkeypatch):
    """``UNet3D.apply(compute_dtype=bf16)`` through the fused block, bf16
    activations between the layers, gives probabilities bit-equal to the
    f32-tensor composition; every block goes through
    ``layers.conv_block_bf16``."""
    spec, params, state, x = network(variant, ord(variant))
    calls = []
    orig = L.conv_block_bf16

    def counted(*a, **k):
        out = orig(*a, **k)
        calls.append(out.dtype)
        return out
    monkeypatch.setattr(L, "conv_block_bf16", counted)
    got = spec.apply(params, state, x, compute_dtype=BF16)
    assert got.dtype == torch.float32
    assert calls == [BF16] * len(spec.block_plan()[0])
    assert torch.equal(got, composed(spec, params, state, x, BF16))


@pytest.mark.parametrize("variant", "abc")
def test_unet_f32_and_training_keep_their_route(variant, monkeypatch):
    """float32 and ``train=True`` never reach the fused block: f32 apply
    is bit-equal to the composition; a bf16 training forward equals the
    composition's (probabilities and running statistics), and its
    backward raises ``BF16_GRAD``."""
    spec, params, state, x = network(variant, 7 + ord(variant))

    def refuse(*a, **k):
        raise AssertionError("the fused block ran")
    monkeypatch.setattr(L, "conv_block_bf16", refuse)
    assert torch.equal(spec.apply(params, state, x),
                       composed(spec, params, state, x, torch.float32))
    probs, new = spec.apply(params, state, x, train=True,
                            compute_dtype=BF16)
    want, want_state = composed(spec, params, state, x, BF16, train=True)
    assert torch.equal(probs, want)
    for name in want_state:
        for k in ("mean", "var"):
            assert torch.equal(new[name][k], want_state[name][k])
    w = params["down0_1"]["conv"]["w"].requires_grad_(True)
    probs, _ = spec.apply(params, state, x, train=True, compute_dtype=BF16)
    with pytest.raises(NotImplementedError, match="A.4"):
        probs.sum().backward()
    assert w.grad is None


# ---- (e) tiles, plans and routing -----------------------------------------

@pytest.mark.parametrize("yx,mt,want", [
    ((160, 16), 4, (32, 16)), ((80, 16), 4, (32, 16)), ((40, 16), 2, (16, 16)),
    ((96, 8), 1, (16, 8)), ((48, 8), 1, (16, 8)), ((96, 8), 4, (64, 8)),
    ((64, 64), 4, (32, 16)), ((8, 8), 1, (8, 16)), ((20, 16), 1, (8, 16)),
    ((204, 84), 1, (16, 8)), ((17, 19), 1, (8, 16)), ((7, 33), 1, (8, 16))])
def test_bf16_tile(yx, mt, want):
    """The tensor-core kernel's block tile pads the fewest pixels, the wide
    one on a tie: U-Net a's 16-deep tiles take (8 MT, 16), b's 8-deep
    (16, 8)."""
    assert hc.bf16_tile(*yx, mt) == want
    y, x = yx
    pad = {t: -(-y // t[0]) * t[0] * -(-x // t[1]) * t[1]
           for t in hc.bf16_tiles(mt)}
    assert pad[want] == min(pad.values())
    assert want in hc.bf16_tiles(mt)


@pytest.mark.parametrize("shape,tile", [
    ((16, 160, 160, 16, 8), (32, 16)), ((216, 96, 96, 8, 64), (16, 8)),
    ((3, 17, 19, 8, 8), (64, 8))])
def test_tma_halo_args_bf16(shape, tile):
    """The bf16 tensor map: dims (c, x, y, z, b), byte strides of 2-byte
    elements, one 8-channel halo plane of the tile a box (16 bytes a
    pixel, the box TMA's 16-byte inner rule needs)."""
    dims, strides, box = hc.tma_halo_args_bf16(shape, tile)
    b, z, y, x, c = shape
    assert dims == (c, x, y, z, b)
    assert strides == (2 * c, 2 * c * x, 2 * c * x * y, 2 * c * x * y * z)
    assert box == (8, tile[1] + 2, tile[0] + 2, 1, 1)
    assert box[0] * 2 == 16 and all(s % 16 == 0 for s in strides)
    assert max(box) <= 256


@pytest.mark.parametrize("shape,c_out", [
    ((16, 160, 160, 16), 8), ((216, 96, 96, 8), 64), ((286, 64, 64, 64), 8),
    ((1, 24, 204, 84), 32), ((3, 37, 45, 9), 40), ((2, 1, 3, 50), 8)])
def test_stem_plan_covers_every_output_once(shape, c_out):
    """The bf16 stem's grid, walked as the kernel decodes its blocks
    (batch, c_out tile, z segment, y tile, x tile; 256 threads of 4 pixels
    x 8 channels), writes every output once; its tile pads the fewest
    pixels of the widths it has."""
    n_sm = 132
    tile, tx, zs, blocks = hc.stem_plan(shape + (1,), c_out, n_sm)
    b, z, y, x = shape
    lanes = 256 * hc.STEM_GROUP // tile
    ty = lanes * hc.STEM_RUN // tx
    assert (tile, tx, ty) == hc.stem_tile(y, x, c_out)
    seen = np.zeros((b, z, y, x, -(-c_out // 8) * 8), np.int32)
    ntx, nty, nzs = -(-x // tx), -(-y // ty), -(-z // zs)
    nco = -(-c_out // tile)
    assert blocks == b * nco * nzs * nty * ntx
    for blk in range(blocks):
        x0 = blk % ntx * tx
        r = blk // ntx
        y0 = r % nty * ty
        r //= nty
        z0 = r % nzs * zs
        r //= nzs
        co0 = r % nco * tile
        bi = r // nco
        seen[bi, z0:z0 + zs, y0:y0 + ty, x0:x0 + tx, co0:co0 + tile] += 1
    assert (seen[..., :c_out] == 1).all()
    pads = [-(-y // (lanes * hc.STEM_RUN // t)) * (lanes * hc.STEM_RUN // t)
            * -(-x // t) * t for t in hc.STEM_TX]
    assert -(-y // ty) * ty * ntx * tx == min(pads)


def test_block_routing_and_plain_on_cpu():
    """On CPU tensors the block runs its plain version and counts no
    launch; on the card it takes one launch of the kernel ``route`` names
    for bf16: the tensor-core kernel for widths % 8 == 0, the stem kernel
    otherwise (every U-Net stem)."""
    for variant, name, shape, ci, co, act in CASES:
        want = "direct_bf16" if ci == 1 else "wgmma_bf16"
        assert hc.route(ci, co, BF16) == want, (variant, name)
    before = [k.launches for k in hc.KERNELS]
    for ci in (1, 16):
        x, w, p = block_inputs((4, 5, 6), ci, 8, ci)
        conv, bn, state = port_params(w, p)
        inv = torch.rsqrt(state["var"] + L.BN_EPS) * bn["scale"]
        got = hc.conv3x3x3_block_bf16(port_input(x), conv["w"], conv["b"],
                                      state["mean"], inv, bn["bias"], "relu")
        assert torch.equal(got, hc.conv3x3x3_block_bf16_plain(
            port_input(x), conv["w"], conv["b"], state["mean"], inv,
            bn["bias"], "relu"))
    assert [k.launches for k in hc.KERNELS] == before


def test_block_checks_its_arguments():
    x, w, p = block_inputs((4, 5, 6), 16, 8, 0)
    conv, bn, state = port_params(w, p)
    xt, inv = port_input(x), torch.ones(8)
    args = (xt, conv["w"], conv["b"], state["mean"], inv, bn["bias"])
    with pytest.raises(ValueError, match="activation"):
        hc.conv3x3x3_block_bf16(*args, "tanh")
    with pytest.raises(ValueError, match="mean, inv and beta"):
        hc.conv3x3x3_block_bf16(*args[:4], torch.ones(9), args[5])
    with pytest.raises(TypeError):
        hc.conv3x3x3_block_bf16(xt.to(torch.float16), *args[1:])
    with pytest.raises(NotImplementedError):
        L.conv_block_bf16({"w": torch.zeros(1, 1, 1, 16, 8)}, bn, state,
                          xt)


# ---- the tensor-core kernel's addressing, emulated --------------------------

def emulate_block_tile(x, packed, nb, tile, z, y0, x0, wg, j):
    """Tile j of warpgroup wg: its 64 x nb partial sums over every stage,
    as ``csrc/conv3x3x3_wgmma_bf16.cu`` reads its operands: the halo
    planes as TMA writes them ((ty + 2) x (tx + 2) pixels of 16 bytes, zero
    out of the volume; a half chunk's second plane not loaded, the
    descriptor's leading offset reading the block's plane of zeros), A's core
    matrix i at the descriptor's start + i * SBO (the halo's row pitch),
    its K halves LBO apart, tile j's start 8 j halo rows on, each tap (dy,
    dx) the start moved (dy * hx + dx) pixels, B through the packed
    weights' core-matrix layout; the partial of each stage added in
    f32."""
    zl, yl, xl, c_in = x.shape
    ty, tx = tile
    hy, hx = ty + 2, tx + 2
    oy, ox = (ty // 2 * wg, 0) if tx == 8 else (0, 8 * wg)
    total = torch.zeros((64, nb))
    k = torch.arange(16)[:, None]
    n = torch.arange(nb)[None, :]
    for s in range(packed.shape[1]):
        chunk, dz = divmod(s, 3)
        zz = z + dz - 1
        planes = []
        for c0 in (16 * chunk, 16 * chunk + 8):
            pl = torch.zeros((hy * hx, 8))
            if c0 >= c_in:              # a half chunk: the plane of zeros
                planes.append(pl)
                continue
            for i in range(hy * hx):
                gy, gx = y0 - 1 + i // hx, x0 - 1 + i % hx
                if 0 <= zz < zl and 0 <= gy < yl and 0 <= gx < xl:
                    pl[i] = x[zz, gy, gx, c0:c0 + 8]
            planes.append(pl)
        part = torch.zeros((64, nb))
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            start = (oy + 8 * j + dy) * hx + ox + dx    # 16-byte pixels
            rows = torch.tensor([start + m // 8 * hx + m % 8
                                 for m in range(64)])
            a = torch.cat([planes[0][rows], planes[1][rows]], dim=1)
            b = packed[0, s, tap][((n // 8) * 2 + k // 8) * 64 +
                                  (n % 8) * 8 + k % 8].float()
            part += hc.round_bf16(a) @ b
        total += part
    return total


@pytest.mark.parametrize("mt,tall", [(1, False), (1, True), (4, False),
                                     (2, True)])
@pytest.mark.parametrize("c_in", [8, 24, 32])
def test_wgmma_bf16_addressing(mt, tall, c_in):
    """The emulated tiles of one block hold the plain bf16 conv (before the
    bias) within ``TOL`` of sum |x w| at a ragged corner of the volume,
    both orientations, one or several tiles a warpgroup, whole and half
    chunks; row m of tile j of warpgroup wg is pixel (oy + 8 j + m // 8,
    ox + m % 8)."""
    rng = np.random.RandomState(c_in + mt)
    zl, yl, xl, c_out = 3, 13 * mt + 3, 11, 16
    x = torch.from_numpy(np.maximum(rng.randn(zl, yl, xl, c_in), 0)
                         .astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 3, c_in, c_out) /
                          np.sqrt(27 * c_in)).astype(np.float32))
    packed, nb = hc.pack_weights_bf16(w)
    zero = torch.zeros(c_out)
    want = hc.conv3x3x3_bias_relu_plain(x, w, zero, False, BF16)
    s = hc.conv3x3x3_bias_relu_plain(hc.round_bf16(x).abs(),
                                     hc.round_bf16(w).abs(), zero, False)
    tile = hc.bf16_tiles(mt)[int(tall)]
    ty, tx = tile
    z, y0, x0 = 2, ty * ((yl - 1) // ty), tx * ((xl - 1) // tx)
    for wg in range(2):
        oy, ox = (ty // 2 * wg, 0) if tall else (0, 8 * wg)
        for j in range(mt):
            got = emulate_block_tile(x, packed, nb, tile, z, y0, x0, wg, j)
            for m in range(64):
                py, px = y0 + oy + 8 * j + m // 8, x0 + ox + m % 8
                if py < yl and px < xl:
                    d = (got[m, :c_out] - want[z, py, px]).abs()
                    assert bool((d <= TOL * s[z, py, px] + 1e-30).all()), \
                        (wg, j, m)


@pytest.mark.parametrize("tall", [False, True])
@pytest.mark.parametrize("c_in", [8, 24])
def test_wgmma_bf16_addressing_nonfinite(tall, c_in):
    """A half chunk (c_in % 16 == 8) with +Inf, -Inf and NaN activations:
    the emulated tiles equal the plain bf16 conv exactly where it is not
    finite (the missing channels' k-half reads the plane of zeros, so no
    Inf meets a zero weight) and hold it within ``TOL`` of sum |x w|
    elsewhere.  The planted voxels lie more than two voxels apart, so no
    output sums two of them."""
    rng = np.random.RandomState(c_in)
    mt = 1
    zl, yl, xl, c_out = 3, 19, 11, 16
    x = np.maximum(rng.randn(zl, yl, xl, c_in), 0).astype(np.float32)
    tile = hc.bf16_tiles(mt)[int(tall)]
    ty, tx = tile
    z, y0, x0 = 1, 0, 0
    last = c_in - 1                     # a channel of the half chunk
    x[1, 1, 1, last] = np.inf
    x[1, 5, 5, 0] = -np.inf
    x[1, 1, 7, last] = np.nan
    x = torch.from_numpy(x)
    w = torch.from_numpy((rng.randn(3, 3, 3, c_in, c_out) /
                          np.sqrt(27 * c_in)).astype(np.float32))
    packed, nb = hc.pack_weights_bf16(w)
    zero = torch.zeros(c_out)
    want = hc.conv3x3x3_bias_relu_plain(x, w, zero, False, BF16)
    fin = torch.where(torch.isfinite(x), x, 0.0)
    s = hc.conv3x3x3_bias_relu_plain(hc.round_bf16(fin).abs(),
                                     hc.round_bf16(w).abs(), zero, False)
    n_nonfinite = 0
    for wg in range(2):
        oy, ox = (ty // 2 * wg, 0) if tall else (0, 8 * wg)
        got = emulate_block_tile(x, packed, nb, tile, z, y0, x0, wg, 0)
        for m in range(64):
            py, px = y0 + oy + m // 8, x0 + ox + m % 8
            if py >= yl or px >= xl:
                continue
            g, want_p = got[m, :c_out], want[z, py, px]
            bad = ~torch.isfinite(want_p)
            assert torch.equal(~torch.isfinite(g), bad), (wg, m)
            assert torch.equal(g[bad].nan_to_num(0.0, 1.0, -1.0),
                               want_p[bad].nan_to_num(0.0, 1.0, -1.0))
            assert torch.equal(g[bad].isnan(), want_p[bad].isnan())
            n_nonfinite += int(bad.sum())
            d = (g[~bad] - want_p[~bad]).abs()
            assert bool((d <= TOL * s[z, py, px][~bad] + 1e-30).all()), \
                (wg, m)
    assert n_nonfinite > 0
