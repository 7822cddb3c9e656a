"""The PR-GLS EM's compensated M-step (``m_step_refine > 0``,
``ops/prgls.py``) against a float64 NumPy EM and against the JAX package's
refined EM on the CPU, on the scenes of JAX's own tests
(``tests/test_matching_stack.py``: the 150-cell sigma-collapse scene
``_imperfect_scene`` and the 30-volume EM-only recurrence).

Bounds are JAX's own test's against float64 (median < 5e-3, max < 3e-2
normalized units, fewer than 200 iterations; the recurrence's median drift
under 0.5 voxels at 50 voxels a unit).  Against JAX's refined run: the
median within 5e-3 too.  The refined EM stops by its stall rule on this
scene (the movement norm does not reach 1e-3), so where it stops follows
the float32 noise of each framework's sums: measured 45 iterations for
JAX and 49 for the port (one torch thread), so the counts are held within
``ITER_SPREAD``.  One M-step solve on equal inputs: the port's within 1e-6
of JAX's, relative to the solution.  Members batched: each equals its run
alone bit for bit.  The drivers with ``m_step_refine`` are held to JAX's
in ``tests/test_torch_driver.py``, ``test_torch_workflow.py`` and
``test_torch_mesh_stardist.py``.

The EM runs on one torch thread (``test_torch_scene.torch_threads``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.linalg import lu_factor, lu_solve

import t3dct_torch  # noqa: F401
from t3dct.ops.df32 import compensated_residual as j_residual
from t3dct.ops.prgls import prgls_with_two_ref as j_prgls
from t3dct_torch.ops.prgls import (REFINE_FLOOR, gaussian_gram,
                                   prgls_quick, prgls_with_two_ref,
                                   solve_m_step, solve_m_step_refined)
from test_matching_stack import _imperfect_scene, _prgls_two_ref_numpy
from test_torch_scene import torch_threads

REFINE = 8
ITER_SPREAD = 8
SOLVE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.fixture(scope="module")
def collapse():
    """The sigma-collapse scene, its float64 EM, and JAX's refined EM."""
    ref, tgt, prior, _, _ = _imperfect_scene()
    want, _ = _prgls_two_ref_numpy(
        prior.astype(np.float64), tgt.astype(np.float64),
        ref.astype(np.float64), ref.astype(np.float64), 3.0, 3.0)
    jres = j_prgls(prior, tgt, ref, ref, beta=3.0, lambda_=3.0,
                   m_step_refine=REFINE)
    return (ref, tgt, prior), want, (np.asarray(jres.tracked),
                                     int(jres.n_iterations))


@pytest.fixture(scope="module")
def port_run(collapse):
    (ref, tgt, prior), _, _ = collapse
    prior_t, tgt_t, ref_t = _t(prior, tgt, ref)
    with torch_threads(1):
        return prgls_with_two_ref(prior_t, tgt_t, ref_t, ref_t, beta=3.0,
                                  lambda_=3.0, m_step_refine=REFINE)


def test_refined_em_tracks_float64(collapse, port_run):
    """JAX's bounds of the refined EM against the float64 EM."""
    _, want, _ = collapse
    d = np.linalg.norm(port_run.tracked.numpy() - want, axis=1)
    assert np.median(d) < 5e-3, np.median(d)
    assert d.max() < 3e-2, d.max()
    assert int(port_run.n_iterations) < 200


def test_refined_em_matches_jax(collapse, port_run):
    """Against JAX's refined run: the median within 5e-3, the iteration
    counts within ``ITER_SPREAD``."""
    _, _, (jtracked, jiters) = collapse
    d = np.linalg.norm(port_run.tracked.numpy() - jtracked, axis=1)
    assert np.median(d) < 5e-3, np.median(d)
    assert abs(int(port_run.n_iterations) - jiters) <= ITER_SPREAD, \
        (int(port_run.n_iterations), jiters)


def test_refined_em_differs_from_the_floored_one(collapse, port_run):
    """The option changes the solve: the floored EM's result is not the
    refined one's."""
    (ref, tgt, prior), _, _ = collapse
    prior_t, tgt_t, ref_t = _t(prior, tgt, ref)
    floored = prgls_with_two_ref(prior_t, tgt_t, ref_t, ref_t, beta=3.0,
                                 lambda_=3.0)
    assert not torch.equal(floored.tracked, port_run.tracked)


def test_refined_recurrence_drift():
    """JAX's 30-volume EM-only recurrence with the compensated solve: the
    median drift from the float64 recurrence under 0.5 voxels."""
    rng = np.random.RandomState(12)
    n = 60
    base = rng.rand(n, 3).astype(np.float32) * 2 - 1
    scale_voxels = 50.0
    tracked_f32 = base.copy()
    tracked_f64 = base.astype(np.float64).copy()
    prev = base
    for t in range(1, 30):
        disp = (0.02 * np.sin(3.0 * prev[:, [1, 2, 0]] + 0.2 * t)
                ).astype(np.float32)
        cur = prev + disp
        perm = rng.permutation(n)
        tgt = cur[perm]
        prior = np.full((n, n), 0.1 / (n - 1), np.float32)
        for new_i, old_i in enumerate(perm):
            prior[new_i, old_i] = 0.9
        res = prgls_with_two_ref(*_t(prior, tgt, prev, tracked_f32),
                                 beta=3.0, lambda_=3.0,
                                 m_step_refine=REFINE)
        tracked_f32 = res.tracked.numpy()
        tracked_f64, _ = _prgls_two_ref_numpy(
            prior.astype(np.float64), tgt.astype(np.float64),
            prev.astype(np.float64), tracked_f64, 3.0, 3.0)
        prev = cur
    drift = np.linalg.norm(tracked_f32 - tracked_f64, axis=1) * scale_voxels
    assert np.median(drift) < 0.5, np.median(drift)


def _m_step_system(seed=3, n=150, sigma_sq=3e-5, lambda_=3.0):
    """A collapsed M-step of the scene's Gram matrix (lambda sigma^2 =
    9e-5, under the preconditioner floor; condition number ~1e6): the
    floored and the true systems and the right-hand side.  Eight
    corrections converge here; further down (lambda sigma^2 = 3e-5) the
    floored preconditioner contracts the error by only ~0.7 a step, and
    both frameworks stop short of the solution, apart."""
    ref, _, _, _, _ = _imperfect_scene(seed)
    rng = np.random.RandomState(seed)
    gram = gaussian_gram(*_t(ref, ref), 9.0).numpy()
    p1 = (rng.rand(n) * 0.9 + 0.1).astype(np.float32)
    dep = (rng.randn(3, n) * 1e-3).astype(np.float32)
    eye = np.eye(n, dtype=np.float32)
    s_true = np.float32(lambda_ * sigma_sq)
    coeff = gram * p1[None, :] + np.maximum(s_true, REFINE_FLOOR) * eye
    a_true = gram * p1[None, :] + s_true * eye
    return coeff, a_true, dep


def _jax_refined_solve(coeff, a_true, dep, steps):
    """The JAX twin's ``m_step_refine`` branch (``ops/prgls.py:154-167``)
    composed from JAX's own ``lu_factor``, ``lu_solve`` and
    ``df32.compensated_residual``."""
    lu_piv = lu_factor(jnp.asarray(coeff).T)
    b, a = jnp.asarray(dep).T, jnp.asarray(a_true).T
    x = lu_solve(lu_piv, b)
    for _ in range(steps):
        x = x + lu_solve(lu_piv, j_residual(b, a, x))
    return np.asarray(x.T)


def test_one_refined_solve_matches_jax():
    """One M-step solve on equal (coeff, a_true, dep): the port's within
    ``SOLVE_RTOL`` of JAX's, relative to the solution (measured 2.8e-8);
    within that of the float64 solve of the true system (4.0e-8), where
    the plain float32 solve of it is off by 8.7e-3 and the floored
    system's exact solution is another solution."""
    coeff, a_true, dep = _m_step_system()
    got = solve_m_step_refined(*_t(coeff, a_true, dep), REFINE).numpy()
    want = _jax_refined_solve(coeff, a_true, dep, REFINE)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= SOLVE_RTOL * scale
    f64 = np.linalg.solve(a_true.T.astype(np.float64),
                          dep.T.astype(np.float64)).T
    err = np.abs(got - f64).max()
    assert err <= SOLVE_RTOL * np.abs(f64).max()
    plain = solve_m_step(*_t(a_true, dep)).numpy()
    assert err < 1e-3 * np.abs(plain - f64).max()
    floored = np.linalg.solve(coeff.T.astype(np.float64),
                              dep.T.astype(np.float64)).T
    assert err < 1e-3 * np.abs(floored - f64).max()


def test_refined_members_batch_as_alone():
    """E = 3 members of different scenes in one batch: each member's
    result equals its run alone bit for bit."""
    scenes = [_imperfect_scene(seed, n=60, wrong=9)[:3] for seed in
              (3, 4, 5)]
    batch = prgls_with_two_ref(
        *_t(*(np.stack(a) for a in zip(*[(p, t, r, r) for r, t, p in
                                         scenes]))),
        beta=3.0, lambda_=3.0, m_step_refine=REFINE)
    for i, (ref, tgt, prior) in enumerate(scenes):
        alone = prgls_with_two_ref(*_t(prior, tgt, ref, ref), beta=3.0,
                                   lambda_=3.0, m_step_refine=REFINE)
        for got, want in zip(batch, alone):
            assert torch.equal(got[i], want), i


def test_refined_quick_is_two_ref():
    """``prgls_quick`` passes ``m_step_refine`` through: the
    single-reference EM is the two-reference one on equal sets."""
    ref, tgt, prior = _imperfect_scene(6, n=40, wrong=6)[:3]
    prior_t, tgt_t, ref_t = _t(prior, tgt, ref)
    quick = prgls_quick(prior_t, tgt_t, ref_t, m_step_refine=REFINE)
    two = prgls_with_two_ref(prior_t, tgt_t, ref_t, ref_t,
                             m_step_refine=REFINE)
    for got, want in zip(quick, two):
        assert torch.equal(got, want)


def test_singular_refined_solve_is_nan_without_raise():
    """A factor with a zero pivot: NaN coefficients, no raise and no host
    read (JAX's ``lu_solve`` gives a non-finite result there)."""
    coeff = torch.zeros((2, 5, 5))
    coeff[1] = torch.eye(5)
    dep = torch.ones((2, 3, 5))
    out = solve_m_step_refined(coeff, coeff, dep, REFINE)
    assert torch.isnan(out[0]).all()
    assert torch.equal(out[1], dep[1])
