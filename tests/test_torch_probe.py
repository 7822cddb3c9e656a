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
from t3dct_torch.ops import ladder
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
