"""The conv probe of the port (``t3dct_torch.scripts.probe_conv_fast`` and
``ops.ladder``) against ``scripts/probe_conv_fast.py``, on the CPU, at a
small shape: (4, 24, 12) voxels, c_in 8, c_out 8 and 16.

The JAX ladder's ``pallas_call``s have no interpret flag and cannot run on
the CPU, so each plain version is held against the reference that the JAX
script itself checks that entry with: ``x + 1``, the einsum, the script's
``conv9gemm`` and ``baseline`` (``L.conv3d`` + ReLU).  The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct_torch.ops import hopper_conv as hc, ladder
from t3dct_torch.scripts import probe_conv_fast as probe

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4, 24, 12)
C_IN = 8
# f32 sums in another order than the reference
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jprobe(tmp_path_factory):
    """``scripts/probe_conv_fast.py`` as a module.  Importing it enables
    JAX's persistent compilation cache, so the cache points at a tmp dir
    while it loads, and the process's settings come back afterwards."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("T3DCT_CACHE_DIR", str(tmp_path_factory.mktemp("xla")))
        spec = importlib.util.spec_from_file_location(
            "jax_probe_conv_fast", ROOT / "scripts" / "probe_conv_fast.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    yield mod
    for k, v in saved.items():
        jax.config.update(k, v)


def volume(seed=0, c=C_IN):
    return np.random.RandomState(seed).rand(*SHAPE, c).astype(np.float32)


def conv_params(c_out, seed=0):
    rng = np.random.RandomState(seed + 10)
    w = (rng.randn(3, 3, 3, C_IN, c_out) / np.sqrt(27 * C_IN)
         ).astype(np.float32)
    b = (rng.randn(c_out) * 0.1).astype(np.float32)
    return w, b


def t(a):
    return torch.from_numpy(np.asarray(a))


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max() + ATOL


@pytest.mark.parametrize("shape", [SHAPE + (C_IN,), (7, 5)])
def test_add_one_matches_x_plus_1_exactly(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jnp.asarray(x) + 1.0)
    for fn in (ladder.ladder_add_one_plain, ladder.ladder_add_one):
        np.testing.assert_array_equal(fn(t(x)).numpy(), want)


@pytest.mark.parametrize("c_out", [8, 16])
def test_pointwise_matmul_matches_einsum(c_out):
    x = volume(2)
    w = np.random.RandomState(1).rand(C_IN, c_out).astype(np.float32)
    want = np.asarray(jnp.einsum("zyxc,co->zyxo", jnp.asarray(x),
                                 jnp.asarray(w)))
    for fn in (ladder.ladder_pointwise_matmul_plain,
               ladder.ladder_pointwise_matmul):
        np.testing.assert_allclose(fn(t(x), t(w)).numpy(), want, rtol=1e-5,
                                   atol=1e-6)


def test_pack_layouts_match_the_scripts():
    """``pack_vz`` and ``pack_w9`` are the JAX script's z-packing
    (``jnp.concatenate`` of three padded slices) and weight transpose."""
    x = volume(3)
    w, _ = conv_params(16)
    z = SHAPE[0]
    xp = jnp.pad(jnp.asarray(x), ((1, 1), (1, 1), (1, 1), (0, 0)))
    vz = jnp.concatenate([xp[0:z], xp[1:z + 1], xp[2:z + 2]], axis=-1)
    w9 = jnp.transpose(jnp.asarray(w), (1, 2, 0, 3, 4)).reshape(
        3, 3, 3 * C_IN, 16)
    np.testing.assert_array_equal(ladder.pack_vz(t(x)).numpy(),
                                  np.asarray(vz))
    np.testing.assert_array_equal(ladder.pack_w9(t(w)).numpy(),
                                  np.asarray(w9))


@pytest.mark.parametrize("c_out", [8, 16])
def test_conv9gemm_matches_the_scripts(jprobe, c_out):
    x = volume(4)
    w, b = conv_params(c_out)
    want = jprobe.conv9gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert_close(probe.conv9gemm(t(x), t(w), t(b)).numpy(), want)
    no_relu = jprobe.conv9gemm(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), relu=False)
    assert_close(probe.conv9gemm(t(x), t(w), t(b), relu=False).numpy(),
                 no_relu)


@pytest.mark.parametrize("c_out", [8, 16])
def test_baseline_matches_the_scripts(jprobe, c_out):
    """The port's baseline (``layers.conv3d`` + ReLU) against the script's
    (``L.conv3d`` + ``jax.nn.relu``)."""
    x = volume(5)
    w, b = conv_params(c_out)
    want = jprobe.baseline({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(x))
    assert_close(probe.baseline({"w": t(w), "b": t(b)}, t(x)).numpy(), want)


@pytest.mark.parametrize("c_out", [8, 16])
def test_conv9view_matches_the_scripts_baseline(jprobe, c_out):
    """Ladder entry C, whose JAX reference is the baseline conv."""
    x = volume(6)
    w, b = conv_params(c_out)
    want = jprobe.baseline({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(x))
    w9 = ladder.pack_w9(t(w))
    for fn in (ladder.ladder_conv9view_bias_relu_plain,
               ladder.ladder_conv9view_bias_relu):
        assert_close(fn(t(x), w9, t(b)).numpy(), want)


@pytest.mark.parametrize("co_pad", [16, 32])
def test_copad_matches_baseline(jprobe, co_pad):
    x = volume(7)
    w, b = conv_params(8)
    p = {"w": t(w), "b": t(b)}
    got = probe.make_copad(p, co_pad)(t(x)).numpy()
    assert_close(got, probe.baseline(p, t(x)).numpy())
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    assert_close(got, jprobe.make_copad(jp, co_pad)(jnp.asarray(x)))


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run their plain versions: no count."""
    x = t(volume(8))
    w, b = conv_params(8)
    before = [k.launches for k in ladder.KERNELS]
    ladder.ladder_add_one(x)
    ladder.ladder_pointwise_matmul(x, t(w[0, 0, 0]))
    ladder.ladder_conv9view_bias_relu(x, ladder.pack_w9(t(w)), t(b))
    assert [k.launches for k in ladder.KERNELS] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrappers_refuse_bad_inputs(bad):
    x = t(volume(9))
    w, b = conv_params(8)
    w9 = ladder.pack_w9(t(w))
    if bad == "dtype":
        with pytest.raises(TypeError):
            ladder.ladder_add_one(x.double())
    elif bad == "shape":
        with pytest.raises(ValueError):
            ladder.ladder_conv9view_bias_relu(x, w9[:, :, :-1], t(b))
    else:
        with pytest.raises(ValueError):
            ladder.ladder_pointwise_matmul(x, t(w[0, 0, 0]).to("meta"))


def test_run_on_cpu_has_the_scripts_keys_and_no_time(jprobe):
    """``run`` on the CPU: the JAX probe's record and ladder keys (less
    their times), the port's additions, every error under its bound, and
    no time anywhere."""
    res = probe.run(device="cpu", shape=SHAPE, c_in=C_IN, c_outs=(8, 16))
    ladder_keys = {"pallas_A_passthrough", "pallas_B_dotgeneral",
                   "pallas_B2_reshape_dot", "pallas_C_9view_conv",
                   "pallas_E_manual_dma"}
    assert set(res) == {"shape", "c8_to_c8", "c8_to_c16"} | ladder_keys
    assert res["shape"] == list(SHAPE)
    # the JAX probe's non-time keys; where the ladder does not run, the
    # port's baseline and nine-view kernel beside them
    assert set(res["c8_to_c8"]) == {"gflop", "gemm9_maxerr",
                                    "copad16_maxerr", "copad32_maxerr"}
    assert set(res["c8_to_c16"]) == {"gflop", "gemm9_maxerr",
                                     "baseline_maxerr", "conv9view_maxerr"}
    gflop = 2 * np.prod(SHAPE) * 27 * C_IN * 16 / 1e9
    assert res["c8_to_c16"]["gflop"] == pytest.approx(gflop)
    for key in ladder_keys:
        rec = res[key]
        assert set(rec) == {"ok", "maxerr", "tol", "flop", "bytes"}
        assert rec["ok"] and rec["maxerr"] <= rec["tol"]
    assert res["pallas_A_passthrough"]["tol"] == 0.0
    for name in ("c8_to_c8", "c8_to_c16"):
        for key, v in res[name].items():
            if key.endswith("_maxerr"):
                assert v <= 1e-5
    text = repr(res)
    assert "_ms" not in text and "tflops" not in text


# ---- the nine-view kernel's host side and arithmetic (C) --------------------

def _b_matrix(flat, nb):
    """The (8 k, nb n) matrix a wgmma B descriptor reads from ``flat``."""
    k = torch.arange(8)[:, None]
    n = torch.arange(nb)[None, :]
    return flat[((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4]


def _tf32_truncate(v):
    """The TF32 value the tensor cores read from an f32 operand."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def c9_window(it, n_iters):
    """The stages one partial sum of the nine-view kernel covers from stage
    ``it`` (``csrc/ladder.cu``: 13 pairs per halo group, then its last
    stage alone)."""
    return [it, it + 1] if it + 1 < n_iters and it % 27 != 26 else [it]


def emulate_conv9view(x, w9, b):
    """``csrc/ladder.cu``'s nine-view kernel in plain f32 arithmetic, in its
    order: per N tile, the stages (halo group, view (dy, dx), z-plane dz)
    in turn, a fresh partial sum per two stages of one group
    (``c9_window``) over the group's chunks
    of the three TF32 products (A split with ``tf32_round``, the packed B
    read as the tensor cores read it: hi exact, lo truncated), each partial
    added to the total at f32; then the bias and the ReLU."""
    z, y, xl, c_in = x.shape
    c_out = w9.shape[3]
    cp, gc, n_groups = ladder.c9_plan(c_in)
    packed, nb = ladder.pack_w9_tc(w9)
    xp = torch.nn.functional.pad(x, (0, cp - c_in, 1, 1, 1, 1, 1, 1))
    order = list(hc.K_ORDER)
    n_iters = 27 * n_groups

    def stage(nt, it):
        grp, s = divmod(it, 27)
        view, dz = divmod(s, 3)
        dy, dx = divmod(view, 3)
        out = torch.zeros((z * y * xl, nb))
        for j in range(gc):
            c0 = 8 * (gc * grp + j)
            a = xp[dz:dz + z, dy:dy + y, dx:dx + xl, c0:c0 + 8]
            a = a[..., order].reshape(-1, 8)
            a_hi = hc.tf32_round(a)
            a_lo = hc.tf32_round(a - a_hi)
            b_hi = _b_matrix(packed[nt, grp, s, j, 0], nb)
            b_lo = _tf32_truncate(_b_matrix(packed[nt, grp, s, j, 1], nb))
            out += a_lo @ b_hi
            out += a_hi @ b_lo
            out += a_hi @ b_hi
        return out

    tiles = []
    for nt in range(packed.shape[0]):
        total = torch.zeros((z * y * xl, nb))
        it = 0
        while it < n_iters:
            window = c9_window(it, n_iters)
            part = torch.zeros_like(total)
            for i in window:
                part += stage(nt, i)
            total += part
            it = window[-1] + 1
        tiles.append(total)
    out = torch.cat(tiles, dim=1)[:, :c_out].reshape(z, y, xl, c_out) + b
    return torch.relu(out)


def _c9_case(c_in, c_out, seed=0):
    rng = np.random.RandomState(seed + 3 * c_in + c_out)
    x = rng.rand(*SHAPE, c_in).astype(np.float32)
    w = (rng.randn(3, 3, 3, c_in, c_out) / np.sqrt(27 * c_in)
         ).astype(np.float32)
    b = (rng.randn(c_out) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("c_in", [5, 8, 32])
@pytest.mark.parametrize("c_out", [32, 40, 128])
def test_conv9view_emulation_matches_the_scripts(jprobe, c_in, c_out):
    """The kernel's three-pass nine-view accumulation holds the JAX probe's
    ``conv9gemm`` and ``baseline`` within the card's budget,
    ``1e-5 * max|ref| + 1e-6``: c_in off the k8 step (5, padded), one chunk
    (8) and one halo group of four (32); one N tile (32), a padded one (40
    in 64) and the widest (128)."""
    x, w, b = _c9_case(c_in, c_out)
    got = emulate_conv9view(t(x), ladder.pack_w9(t(w)), t(b)).numpy()
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    for want in (jprobe.conv9gemm(jx, jw, jb),
                 jprobe.baseline({"w": jw, "b": jb}, jx)):
        assert_close(got, want)


@pytest.mark.parametrize("c_in,c_out", [(5, 40), (16, 8), (32, 128),
                                        (24, 136), (40, 16)])
def test_w9_packing_against_an_index_walk(c_in, c_out):
    """Every element of the packed stages against ``w9`` by a brute-force
    walk of the layout the docstring gives: hi and lo of the right (view,
    z-plane, channel, output), zero past c_in and c_out."""
    _, w, _ = _c9_case(c_in, c_out)
    w9 = ladder.pack_w9(t(w))
    packed, nb = ladder.pack_w9_tc(w9)
    cp, gc, n_groups = ladder.c9_plan(c_in)
    assert cp % 8 == 0 and cp - c_in < 8 and gc * n_groups * 8 == cp
    assert nb == hc.n_tile(c_out)
    n_nt = -(-c_out // nb)
    assert packed.shape == (n_nt, n_groups, 27, gc, 2, 8 * nb)
    hi, lo = hc.split_tf32(w9)
    want = torch.zeros_like(packed)
    for nt, grp, s, j, part, k, n in np.ndindex(n_nt, n_groups, 27, gc, 2,
                                                8, nb):
        view, dz = divmod(s, 3)
        ch = 8 * (gc * grp + j) + hc.K_ORDER[k]
        co = nt * nb + n
        if ch < c_in and co < c_out:
            want[nt, grp, s, j, part,
                 ((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4] = \
                (hi, lo)[part][view // 3, view % 3, dz * c_in + ch, co]
    assert torch.equal(packed, want)


@pytest.mark.parametrize("c_in,plan", [(5, (8, 1, 1)), (8, (8, 1, 1)),
                                       (24, (24, 1, 3)), (32, (32, 4, 1)),
                                       (48, (48, 2, 3)), (40, (40, 1, 5)),
                                       (96, (96, 4, 3))])
def test_conv9view_plan(c_in, plan):
    """c_in padded to the k8 step; the halo group is the largest of the
    kernel's 4, 2 or 1 chunks that divides them, so all of c_in 32 is one
    group."""
    assert ladder.c9_plan(c_in) == plan


def test_conv9view_tensor_map():
    """The halo box covers one chunk's three z-planes: 8 channels, the
    (16 + 2, 8 + 2) halo, 3 z, from the same 16-byte strides as the
    backbone conv's map."""
    dims, strides, box = ladder.c9_tma_args((24, 204, 84, 32))
    assert dims == (32, 84, 204, 24, 1)
    assert strides == (128, 128 * 84, 128 * 84 * 204, 128 * 84 * 204 * 24)
    assert box == (8, ladder.C9_TX + 2, ladder.C9_TY + 2, 3, 1)


def test_w9_packing_is_cached_per_tensor():
    """The card wrapper packs ``w9`` once per tensor (repacking only after
    an in-place change), in its own cache entry beside the backbone
    conv's."""
    _, w, _ = _c9_case(8, 16)
    w9 = ladder.pack_w9(t(w))
    pack = lambda v: ladder.pack_w9_tc(v)  # noqa: E731
    p1, nb = hc.cached_pack(w9, "ladder_conv9view", pack)
    assert hc.cached_pack(w9, "ladder_conv9view", pack)[0] is p1
    assert hc.packed_weights(t(w))[0] is not p1
    w9.mul_(2.0)
    assert hc.cached_pack(w9, "ladder_conv9view", pack)[0] is not p1


# ---- the pointwise kernel's plan (B) ----------------------------------------

@pytest.mark.parametrize("m", [1, 255, 256, 257, 411264, 3 * 256 * 264 + 5])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_pointwise_plan_covers_every_row_once(m, n_sm):
    """The persistent grid walked as the kernel walks it: every row of x is
    in exactly one tile of one block, the ragged last tile ends at m, and M
    below one tile is one block; with more tiles than resident blocks each
    block takes several."""
    cp, cop, nb, tiles, blocks = ladder.pointwise_plan(m, 32, 32, n_sm)
    assert (cp, cop, nb) == (32, 32, 32)
    assert tiles == -(-m // ladder.PW_ROWS)
    assert blocks == min(tiles, ladder.PW_BLOCKS_PER_SM * n_sm)
    hits = np.zeros(m, np.int32)
    for blk in range(blocks):
        # the kernel's walk: `mine` tiles, tile blk + i * blocks
        mine = -(-(tiles - blk) // blocks) if blk < tiles else 0
        for i in range(mine):
            r0 = (blk + i * blocks) * ladder.PW_ROWS
            hits[r0:min(r0 + ladder.PW_ROWS, m)] += 1
        if tiles > blocks and blk == 0:
            assert mine > 1
    assert (hits == 1).all()


@pytest.mark.parametrize("c_in,c_out,want", [
    (32, 32, (32, 32, 32)), (8, 40, (8, 40, 32)), (48, 16, (48, 16, 16)),
    (5, 3, (8, 4, 8)), (12, 9, (12, 12, 16))])
def test_pointwise_widths(c_in, c_out, want):
    """Widths padded to TMA's 16-byte rule; the N tile is the narrowest of
    8, 16, 32 that holds c_out (32 above: several tiles, one x read)."""
    assert ladder.pointwise_plan(1000, c_in, c_out, 132)[:3] == want

