"""PR-GLS non-rigid registration by EM (counterpart of
``3deecelltracker_tpu/ops/prgls.py::prgls_with_two_ref``, ``m_step_refine=0``
only).

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

CHECK_EVERY = 16
VOL = 1.0                   # outlier volume of the E-step
CONVERGENCE_EPSILON = 1e-3  # stop when the ref movement norm falls below
SOLVE_FLOOR = 1e-3          # floor of lambda sigma^2 in the M-step solve
STALL_LIMIT = 30.0          # stop after this many non-improving iterations


def gaussian_gram(a: torch.Tensor, b: torch.Tensor,
                  beta_sq) -> torch.Tensor:
    return torch.exp(-pairwise_sq_dists(a, b) / (2.0 * beta_sq))


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
        return torch.linalg.solve(coeff.T, dep.T).T               # (3, n)

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
