"""The port's double-single primitives (``ops/df32.py``) against float64
and against the JAX package's ``ops/df32.py`` on the CPU, on the seeded
inputs of JAX's own ``tests/test_df32.py``.

``two_sum`` and ``two_prod`` are error-free: the pair sums to the exact
result in float64, and since the rounded part is the same float32
operation on both sides, the pair equals JAX's bit for bit.  ``df_sum``
keeps a sum that cancels to ~1e-6 of its terms where a float32 sum loses
it.  ``compensated_residual`` is within ``1e-6`` of the largest float64
residual of the true one and of JAX's (JAX's bound); the naive float32
residual is more than ten times further off."""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.ops import df32 as jdf32
from t3dct_torch.ops import df32

RES_RTOL = 1e-6


def _f64(*xs):
    return [np.asarray(x, np.float64) for x in xs]


def _pair_inputs(seed, scale_a, scale_b, n=1000):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32) * scale_a,
            rng.randn(n).astype(np.float32) * scale_b)


@pytest.mark.parametrize("name,seed,scales,exact", [
    ("two_sum", 0, (1e6, 1.0), np.add),
    ("two_prod", 1, (1.0, 100.0), np.multiply),
    ("fast_two_sum", 0, (1e6, 1.0), np.add),
], ids=["two_sum", "two_prod", "fast_two_sum"])
def test_error_free_transform_is_exact_and_jax(name, seed, scales, exact):
    """(r, e) with r + e the exact float64 result; both parts equal to
    JAX's bit for bit (``fast_two_sum``: |a| >= |b| holds here, the a's
    a million times larger)."""
    a, b = _pair_inputs(seed, *scales)
    if name == "fast_two_sum":
        a = np.where(np.abs(a) >= np.abs(b), a, b * 2).astype(np.float32)
    r, e = getattr(df32, name)(torch.from_numpy(a), torch.from_numpy(b))
    got = np.asarray(r, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact(*_f64(a, b)))
    jr, je = jax.jit(getattr(jdf32, name))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_df_add_is_jax():
    """Double-single plus double-single, JAX's bits."""
    rng = np.random.RandomState(4)
    x = [rng.randn(500).astype(np.float32) * s for s in (1e3, 1e-5)]
    y = [rng.randn(500).astype(np.float32) * s for s in (1e3, 1e-5)]
    got = df32.df_add(tuple(map(torch.from_numpy, x)),
                      tuple(map(torch.from_numpy, y)))
    want = jax.jit(jdf32.df_add)(tuple(map(jnp.asarray, x)),
                                 tuple(map(jnp.asarray, y)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cancelling_values():
    rng = np.random.RandomState(2)
    big = rng.randn(256).astype(np.float32) * 1e4
    vals = np.concatenate([big, -big, rng.randn(64).astype(np.float32)])
    rng.shuffle(vals)
    return vals


def test_df_sum_beats_the_plain_sum():
    """Terms that cancel to the 64 small ones: within 1e-3 of the float64
    sum, where the float32 sum is off by more; the same (hi, lo) as
    JAX's tree."""
    vals = _cancelling_values()
    v = torch.from_numpy(vals)
    hi, lo = df32.df_sum(v, torch.zeros_like(v), axis=0)
    want = np.sum(vals.astype(np.float64))
    got = float(hi) + float(lo)
    assert abs(got - want) < 1e-3 * max(abs(want), 1.0)
    plain = float(torch.sum(v))
    assert abs(got - want) < abs(plain - want)
    jhi, jlo = jax.jit(lambda x: jdf32.df_sum(x, jnp.zeros_like(x), 0))(
        jnp.asarray(vals))
    assert (float(hi), float(lo)) == (float(jhi), float(jlo))


@pytest.mark.parametrize("k", [1, 5, 64, 150])
def test_df_sum_any_length_and_axis(k):
    """Lengths that are and are not powers of two, summed along a middle
    axis, as JAX's tree sums them."""
    rng = np.random.RandomState(k)
    hi = rng.randn(3, k, 4).astype(np.float32)
    lo = (rng.randn(3, k, 4) * 1e-8).astype(np.float32)
    got = df32.df_sum(torch.from_numpy(hi), torch.from_numpy(lo), axis=1)
    want = jdf32.df_sum(jnp.asarray(hi), jnp.asarray(lo), axis=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ill_conditioned(seed=3, n=120):
    """JAX's test system: an ill-conditioned SPD matrix like the PR-GLS
    M-step's, and an x 1e-4 off the solution, so that the residual is ~1e9
    times smaller than b."""
    rng = np.random.RandomState(seed)
    g = np.exp(-((rng.rand(n, 1) - rng.rand(1, n)) ** 2) * 30)
    a64 = g @ g.T + 1e-6 * np.eye(n)
    x64 = rng.randn(n, 3)
    b64 = a64 @ x64
    x = (x64 + 1e-4 * rng.randn(n, 3)).astype(np.float32)
    return a64.astype(np.float32), x, b64.astype(np.float32)


def test_compensated_residual_vs_float64_and_jax():
    a, x, b = _ill_conditioned()
    want = b.astype(np.float64) - a.astype(np.float64) @ x.astype(np.float64)
    denom = np.abs(want).max()
    got = df32.compensated_residual(*map(torch.from_numpy, (b, a, x)))
    got = got.numpy().astype(np.float64)
    assert np.abs(got - want).max() < RES_RTOL * denom
    jgot = np.asarray(jax.jit(jdf32.compensated_residual)(
        *map(jnp.asarray, (b, a, x))), np.float64)
    assert np.abs(got - jgot).max() < RES_RTOL * denom
    naive = (torch.from_numpy(b) - torch.from_numpy(a) @
             torch.from_numpy(x)).numpy().astype(np.float64)
    assert np.abs(naive - want).max() > 10 * np.abs(got - want).max()


def test_compensated_residual_batches_members():
    """A leading member axis: each member equals its run alone."""
    systems = [_ill_conditioned(seed, 40) for seed in (5, 6, 7)]
    a, x, b = (torch.from_numpy(np.stack(s)) for s in zip(*systems))
    got = df32.compensated_residual(b, a, x)
    for i in range(3):
        assert torch.equal(got[i], df32.compensated_residual(b[i], a[i],
                                                             x[i]))


def test_module_holds_no_fused_operation():
    """The transforms hold only if each step rounds alone: the module
    calls no fused multiply-add and no compiler."""
    fused = {"addcmul", "addcdiv", "addmm", "baddbmm", "addbmm", "addmv",
             "compile", "fma", "lerp", "script", "trace"}
    tree = ast.parse(inspect.getsource(df32))
    called = {n.func.attr if isinstance(n.func, ast.Attribute)
              else getattr(n.func, "id", "")
              for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert not called & fused, called & fused


def test_chip_smoke_df32_check_passes_on_the_cpu():
    """``chip_smoke.df32_on_card`` (phase 29's check) on CPU tensors: it
    finds nothing off, so a failure on the card is the card's."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    assert chip_smoke.df32_on_card(torch.device("cpu")) == []
