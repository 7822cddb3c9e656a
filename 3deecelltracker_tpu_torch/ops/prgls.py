"""PR-GLS non-rigid registration by EM (counterpart of
``3deecelltracker_tpu/ops/prgls.py``: ``prgls_with_two_ref`` with
``m_step_refine=0`` only, and the legacy v0.4 ``pr_gls_quick``).

Motion T(X) = X + C G with the gaussian Gram matrix G; the M-step solves
(G diag(P1) + max(lambda sigma^2, floor) I) C^T = (Y^T P - X^T diag(P1))^T.
Every product is true float32 (the device pins TF32 off): the EM's 1e-3
convergence tail is unreachable otherwise.  The JAX ``while_loop`` becomes
a Python loop whose state freezes under a device-side ``active`` flag; the
host reads it every ``CHECK_EVERY`` iterations, so the loop stops at the
same iteration as JAX's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import numerics
from .knn import pairwise_sq_dists
from .matching import legacy_init_match

CHECK_EVERY = 16
VOL = 1.0                   # outlier volume of the E-step
CONVERGENCE_EPSILON = 1e-3  # stop when the ref movement norm falls below
SOLVE_FLOOR = 1e-3          # floor of lambda sigma^2 in the M-step solve
STALL_LIMIT = 30.0          # stop after this many non-improving iterations


def gaussian_gram(a: torch.Tensor, b: torch.Tensor,
                  beta_sq) -> torch.Tensor:
    return torch.exp(-pairwise_sq_dists(a, b) / (2.0 * beta_sq))


def solve_m_step(coeff: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    """C (3, n) with ``C coeff = dep``, the v1.0 M-step's solve.  A system
    that LU finds singular gives NaN, as ``jnp.linalg.solve`` gives a
    non-finite result there, and nothing is read on the host: no sync, and
    no raise (``torch.linalg.solve`` would raise)."""
    c, info = torch.linalg.solve_ex(coeff.T, dep.T)
    return torch.where(info != 0, torch.nan, c.T)


class PrglsResult(NamedTuple):
    tracked: torch.Tensor          # moved second reference (l, 3)
    moved_ref: torch.Tensor        # T(X) (n, 3)
    posterior: torch.Tensor        # (m, n)
    n_iterations: torch.Tensor     # 0-d int32
    coefficients: torch.Tensor     # final C (3, n)


def prgls_with_two_ref(init_match: torch.Tensor, ptrs_tgt: torch.Tensor,
                       ptrs_ref: torch.Tensor, tracked_ref: torch.Tensor,
                       beta: float = 3.0, lambda_: float = 3.0,
                       max_iteration: int = 2000,
                       tgt_mask: Optional[torch.Tensor] = None,
                       ref_mask: Optional[torch.Tensor] = None
                       ) -> PrglsResult:
    """Fit the motion field on (ptrs_ref -> ptrs_tgt) guided by
    ``init_match`` and apply it to ``tracked_ref`` (see the JAX twin for
    the reference-parity details: the first movement is discarded, gamma
    clamps at 1e-4, the stop is a movement norm < 1e-3 or 30 stalled
    iterations)."""
    m, n = init_match.shape
    dev = init_match.device
    f32 = torch.float32
    if tgt_mask is None:
        tgt_mask = torch.ones((m,), dtype=torch.bool, device=dev)
    if ref_mask is None:
        ref_mask = torch.ones((n,), dtype=torch.bool, device=dev)

    beta_sq = beta ** 2
    valid_pair = tgt_mask[:, None] & ref_mask[None, :]
    prior = torch.where(valid_pair, init_match.to(f32), 0.0)
    gram_nn = gaussian_gram(ptrs_ref, ptrs_ref, beta_sq)
    gram_nn = torch.where(ref_mask[:, None] & ref_mask[None, :], gram_nn, 0.0)
    gram_ln = gaussian_gram(tracked_ref, ptrs_ref, beta_sq)
    gram_ln = torch.where(ref_mask[None, :], gram_ln, 0.0)
    d2_init = pairwise_sq_dists(ptrs_tgt, ptrs_ref)
    n_pairs = torch.sum(valid_pair.to(f32))
    sigma_sq = torch.sum(torch.where(valid_pair, d2_init, 0.0)) / \
        (3.0 * n_pairs)
    m_valid = torch.sum(tgt_mask.to(f32))
    eye = torch.eye(n, dtype=f32, device=dev)

    def e_step(pred_ref, sigma_sq, gamma):
        k = gaussian_gram(ptrs_tgt, pred_ref, sigma_sq)
        p_joint = (1.0 - gamma) * prior * k / \
            (2.0 * math.pi * sigma_sq) ** 1.5
        p_joint = torch.where(valid_pair, p_joint, 0.0)
        denom = torch.sum(p_joint, dim=1) + gamma / VOL
        post = p_joint / denom[:, None]
        return torch.where(valid_pair, post, 0.0)

    def m_step(post, pred_ref, sigma_sq):
        p1 = torch.sum(post, dim=0)
        dep = ptrs_tgt.T @ post - pred_ref.T * p1[None, :]        # (3, n)
        s_eff = torch.clamp_min(lambda_ * sigma_sq, SOLVE_FLOOR)
        coeff = gram_nn * p1[None, :] + s_eff * eye
        return solve_m_step(coeff, dep)                           # (3, n)

    pred_ref = ptrs_ref.to(f32)
    pred_tracked = tracked_ref.to(f32)
    gamma = torch.tensor(0.05, dtype=f32, device=dev)
    post = torch.zeros((m, n), dtype=f32, device=dev)
    move_norm = torch.tensor(torch.inf, dtype=f32, device=dev)
    best = torch.tensor(torch.inf, dtype=f32, device=dev)
    stall = torch.tensor(0.0, dtype=f32, device=dev)
    it = torch.ones((), dtype=torch.int32, device=dev)

    def running():
        converged = (it > 1) & ((move_norm < CONVERGENCE_EPSILON)
                                | (stall >= STALL_LIMIT))
        return (it < max_iteration) & ~converged

    while bool(running()):
        for _ in range(CHECK_EVERY):
            active = running()
            p = e_step(pred_ref, sigma_sq, gamma)
            c = m_step(p, pred_ref, sigma_sq)
            move_ref = (c @ gram_nn).T
            move_tracked = (c @ gram_ln.T).T
            apply = active & (it > 1)
            n_pred_ref = torch.where(apply, pred_ref + move_ref, pred_ref)
            pred_tracked = torch.where(apply, pred_tracked + move_tracked,
                                       pred_tracked)
            sum_post = torch.sum(p)
            n_gamma = torch.clamp_min(1.0 - sum_post / m_valid, 1e-4)
            d2 = pairwise_sq_dists(n_pred_ref, ptrs_tgt).T
            n_sigma = torch.sum(torch.where(valid_pair, d2, 0.0) * p) / \
                (3.0 * torch.clamp_min(sum_post, 1e-20))
            n_sigma = torch.clamp_min(n_sigma, 1e-12)
            n_move = numerics.sqrt(torch.sum(torch.square(torch.where(
                ref_mask[:, None], move_ref, 0.0))))
            improving = n_move < 0.99 * best
            n_stall = torch.where(improving, 0.0, stall + 1.0)
            n_best = torch.minimum(best, n_move)
            pred_ref = n_pred_ref
            post = torch.where(active, p, post)
            sigma_sq = torch.where(active, n_sigma, sigma_sq)
            gamma = torch.where(active, n_gamma, gamma)
            move_norm = torch.where(active, n_move, move_norm)
            best = torch.where(active, n_best, best)
            stall = torch.where(active, n_stall, stall)
            it = it + active.to(torch.int32)

    c_final = m_step(post, pred_ref, sigma_sq)
    return PrglsResult(pred_tracked, pred_ref, post, it, c_final)


class LegacyPrglsResult(NamedTuple):
    posterior: torch.Tensor        # final P (m, n)
    moved_ref: torch.Tensor        # T(X) (n, 3)
    coefficients: torch.Tensor     # C (3, n)
    solve_failed: torch.Tensor     # 0-d bool: an M-step solve failed


def legacy_posterior(init_match: torch.Tensor, dist_sq: torch.Tensor,
                     valid: torch.Tensor, sigma_sq: torch.Tensor,
                     gamma: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """The v0.4 E-step (``prgls.py:298-304`` of the JAX twin): the prior
    times the gaussian likelihood, over the row sum plus the outlier term
    gamma (2 pi sigma^2)^1.5 / ((1 - gamma) vol).  A row whose denominator
    is exactly 0 -- every likelihood underflowed while gamma rounded to 0,
    which float32 reaches on a full-size recording -- gets 0, the limit
    for gamma -> 0+; the JAX twin's 0/0 = NaN there poisons the M-step."""
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32,
                          device=dist_sq.device)
    p1 = init_match * torch.exp(-torch.where(valid, dist_sq, 0.0)
                                / (2.0 * sigma_sq))
    p1 = torch.where(valid, p1, 0.0)
    denom = torch.sum(p1, dim=1) + gamma * (two_pi * sigma_sq) ** 1.5 \
        / ((1.0 - gamma) * vol)
    return torch.where(valid & (denom != 0)[:, None], p1 / denom[:, None],
                       0.0)


def pr_gls_quick(x_ref: torch.Tensor, y_tgt: torch.Tensor,
                 corr: torch.Tensor, beta=300.0, max_iteration: int = 20,
                 lambda_=0.1, vol: float = 1e8,
                 ref_mask: Optional[torch.Tensor] = None,
                 tgt_mask: Optional[torch.Tensor] = None
                 ) -> LegacyPrglsResult:
    """Legacy v0.4 PR-GLS (``track.py:11-114``) with its own numerics:
    gamma starts at 0.1, the E-step outlier term is
    gamma (2 pi sigma^2)^1.5 / ((1 - gamma) vol), the motion applies from
    the first iteration, sigma^2 clamps at >= 1, and exactly
    ``max_iteration - 1`` rounds run, with no convergence break (so no host
    sync).  One repair: a posterior row whose denominator is exactly 0 is 0
    where the JAX twin gives 0/0 = NaN (``legacy_posterior``).  The solves
    check nothing on the way: ``solve_failed`` is True when any of them met
    a zero pivot or gave a non-finite coefficient, for the caller to raise
    on (``engine.legacy.legacy_fit_and_predict`` does).  The prior
    is ``legacy_init_match`` of ``corr``.  ``beta`` and ``lambda_`` may be
    float32 0-d tensors (the fused fit passes them so).
    Padded points (parked far, masks False) take no part: the counts n, m
    are the valid ones, padded refs get zero coefficients."""
    f32 = torch.float32
    dev = x_ref.device
    n_static, m_static = x_ref.shape[0], y_tgt.shape[0]
    if ref_mask is None:
        ref_mask = torch.ones((n_static,), dtype=torch.bool, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones((m_static,), dtype=torch.bool, device=dev)
    beta = torch.as_tensor(beta, dtype=f32, device=dev)
    lambda_ = torch.as_tensor(lambda_, dtype=f32, device=dev)
    valid = tgt_mask[:, None] & ref_mask[None, :]
    n = torch.sum(ref_mask.to(f32))
    m = torch.sum(tgt_mask.to(f32))
    init_match = legacy_init_match(corr, threshold=0.5, ref_mask=ref_mask,
                                   tgt_mask=tgt_mask)
    gram = gaussian_gram(x_ref, x_ref, beta * beta)
    gram = torch.where(ref_mask[:, None] & ref_mask[None, :], gram, 0.0)
    sigma_sq = torch.sum(torch.where(valid.T, pairwise_sq_dists(x_ref, y_tgt),
                                     0.0)) / (3.0 * n * m)
    eye = torch.eye(n_static, dtype=f32, device=dev)
    vol_t = torch.tensor(vol, dtype=f32, device=dev)
    x_ref_t = x_ref.to(f32).T
    t_x = x_ref.to(f32)
    gamma = torch.tensor(0.1, dtype=f32, device=dev)
    post = torch.zeros((m_static, n_static), dtype=f32, device=dev)
    c = torch.zeros((3, n_static), dtype=f32, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    # the reference iterates range(1, max_iteration)
    for _ in range(1, max_iteration):
        post = legacy_posterior(init_match, pairwise_sq_dists(y_tgt, t_x),
                                valid, sigma_sq, gamma, vol_t)
        diag_p = torch.sum(post, dim=0)                          # (n,)
        a = gram * diag_p[None, :] + lambda_ * sigma_sq * eye
        b = y_tgt.T @ post - x_ref_t * diag_p[None, :]
        # solve_ex: no host sync per iteration; its info is collected
        c, info = torch.linalg.solve_ex(a.T, b.T)
        c = c.T                                                  # (3, n)
        failed = failed | (info != 0) | ~torch.isfinite(c).all()
        c = torch.where(ref_mask[None, :], c, 0.0)
        t_x = (x_ref_t + c @ gram).T
        m_p = torch.sum(post)
        gamma = 1.0 - m_p / m
        dist_sq2 = pairwise_sq_dists(y_tgt, t_x)
        sigma_sq = torch.clamp_min(
            torch.sum(post * torch.where(valid, dist_sq2, 0.0))
            / (3.0 * m_p), 1.0)
    return LegacyPrglsResult(post, t_x, c, failed)
