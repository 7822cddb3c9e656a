"""The ensemble's member fan-out on one card (counterpart of
``3deecelltracker_tpu/parallel/ensemble.py``: ``ensemble_member_predictions``,
``ensemble_track_step`` and ``pad_members``, :25-73 and :119).

The reference predicts a volume from up to 20 earlier volumes in a serial
loop and combines the predictions with a 10% trimmed mean
(``trackerlite.py:111-125``).  JAX ``vmap``s ``track_step`` over the
members; here ``engine.tracker.track_step`` takes the member axis itself:
one batch of kNN features, FFN scores, peels and EM iterations, each
member computed as it is alone (a member whose EM has stopped keeps its
state while the others iterate).  The sharded builders
(``make_sharded_ensemble_*``, JAX :76-116) split the members over the
ranks of a mesh axis: each rank runs its share through the same batched
``track_step`` and an ``all_gather`` gives every rank the (E, L, 3) stack,
so each member equals its run on one card bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..engine.tracker import track_step
from ..ops.trim import trim_mean
from .comm import all_gather_tensors
from .mesh import MeshAxis, mesh_axis


def ensemble_member_predictions(ffn_params, ffn_state,
                                confirmed_stack: torch.Tensor,  # (E, L, 3)
                                seg_t1_stack: torch.Tensor,     # (E, M, 3)
                                seg_t1_masks: torch.Tensor,     # (E, M)
                                seg_t2: torch.Tensor,           # (M, 3)
                                seg_t2_mask: torch.Tensor,      # (M,)
                                beta: float = 3.0, lambda_: float = 3.0,
                                k_points: int = 20,
                                max_iteration: int = 2000,
                                m_step_refine: int = 0) -> torch.Tensor:
    """Every member's tracked real coordinates at t2, (E, L, 3)."""
    return track_step(ffn_params, ffn_state, confirmed_stack, seg_t1_stack,
                      seg_t1_masks, seg_t2, seg_t2_mask, beta=beta,
                      lambda_=lambda_, k_points=k_points,
                      max_iteration=max_iteration,
                      m_step_refine=m_step_refine).tracked


def ensemble_track_step(ffn_params, ffn_state,
                        confirmed_stack: torch.Tensor,
                        seg_t1_stack: torch.Tensor,
                        seg_t1_masks: torch.Tensor,
                        seg_t2: torch.Tensor, seg_t2_mask: torch.Tensor,
                        beta: float = 3.0, lambda_: float = 3.0,
                        k_points: int = 20, max_iteration: int = 2000,
                        trim_proportion: float = 0.1,
                        m_step_refine: int = 0) -> torch.Tensor:
    """All members at once, combined by the trimmed mean: (L, 3)."""
    preds = ensemble_member_predictions(
        ffn_params, ffn_state, confirmed_stack, seg_t1_stack, seg_t1_masks,
        seg_t2, seg_t2_mask, beta=beta, lambda_=lambda_, k_points=k_points,
        max_iteration=max_iteration, m_step_refine=m_step_refine)
    return trim_mean(preds, trim_proportion, axis=0)


def sharded_member_predictions(ax: MeshAxis, ffn_params, ffn_state,
                               confirmed_stack: torch.Tensor,
                               seg_t1_stack: torch.Tensor,
                               seg_t1_masks: torch.Tensor,
                               seg_t2: torch.Tensor,
                               seg_t2_mask: torch.Tensor, **kwargs
                               ) -> torch.Tensor:
    """:func:`ensemble_member_predictions` with the E members split in
    contiguous shares over the ranks of ``ax`` (E a multiple of its size),
    gathered on every rank: (E, L, 3)."""
    e = int(confirmed_stack.shape[0])
    if e % ax.size:
        raise ValueError(f"{e} members do not split over {ax.size} ranks: "
                         f"pad them to a multiple (pad_members)")
    per = e // ax.size
    mine = slice(ax.index * per, (ax.index + 1) * per)
    preds = ensemble_member_predictions(
        ffn_params, ffn_state, confirmed_stack[mine], seg_t1_stack[mine],
        seg_t1_masks[mine], seg_t2, seg_t2_mask, **kwargs)
    return torch.cat([p[0] for p in all_gather_tensors(ax, [preds])])


def make_sharded_ensemble_members(mesh, data_axis: str = "data",
                                  **static_kwargs):
    """``fn(ffn_params, ffn_state, confirmed_stack, seg_t1_stack,
    seg_t1_masks, seg_t2, seg_t2_mask) -> (E, L, 3)``: the members split
    over the mesh's ``data_axis`` (E a multiple of its size) and gathered
    on every rank; every rank of the axis calls it with the same
    arguments.  A caller that padded E with :func:`pad_members` drops the
    padding rows before the trimmed mean (a trim over repeated members
    biases the combine); ``engine.pipeline.track_timelapse(mesh=)`` does.
    ``static_kwargs``: ``beta``, ``lambda_``, ``k_points``,
    ``max_iteration``, ``m_step_refine``."""
    ax = mesh_axis(mesh, data_axis)

    def fn(ffn_params, ffn_state, confirmed_stack, seg_t1_stack,
           seg_t1_masks, seg_t2, seg_t2_mask):
        return sharded_member_predictions(
            ax, ffn_params, ffn_state, confirmed_stack, seg_t1_stack,
            seg_t1_masks, seg_t2, seg_t2_mask, **static_kwargs)
    return fn


def make_sharded_ensemble_step(mesh, data_axis: str = "data",
                               **static_kwargs):
    """As :func:`make_sharded_ensemble_members`, combined by the trimmed
    mean over ALL E rows: (L, 3), cutting ``trim_proportion`` of
    ``static_kwargs`` (0.1 by default) from each end, as JAX's
    ``ensemble_track_step`` takes it.  With padded members use
    :func:`make_sharded_ensemble_members` and trim the real rows."""
    trim_proportion = static_kwargs.pop("trim_proportion", 0.1)
    members = make_sharded_ensemble_members(mesh, data_axis,
                                            **static_kwargs)

    def fn(*args):
        return trim_mean(members(*args), trim_proportion, axis=0)
    return fn


def pad_members(arrays: List[np.ndarray], multiple: int
                ) -> Tuple[np.ndarray, int]:
    """Stack member arrays, repeating the last to a multiple of
    ``multiple``; returns (stack, n_real).  The port's drivers run the
    real members only (no program to compile once), so only callers that
    want JAX's padded stack use it; a trimmed mean over padded members
    must take ``stack[:n_real]``."""
    n = len(arrays)
    stack = list(arrays)
    while len(stack) % multiple:
        stack.append(stack[-1])
    return np.stack(stack), n


def lead_members(ax: MeshAxis, ffn_params, ffn_state,
                 confirmed_stack: torch.Tensor, seg_t1_stack: torch.Tensor,
                 seg_t1_masks: torch.Tensor, seg_t2: torch.Tensor,
                 seg_t2_mask: torch.Tensor, **kwargs) -> torch.Tensor:
    """Rank 0 of ``ax`` (the rank that tracks) fans the members out: it
    pads them to a multiple of the axis size (repeating the last), sends
    the inputs, the FFN and ``kwargs`` to the other ranks (waiting in
    :class:`MemberFollower`), runs its share and returns the real
    members' (E, L, 3) predictions, each equal to its one-card run."""
    from .comm import broadcast_object, tree_to
    e = int(confirmed_stack.shape[0])
    idx = [min(i, e - 1) for i in range(-(-e // ax.size) * ax.size)]
    args = (ffn_params, ffn_state, confirmed_stack[idx], seg_t1_stack[idx],
            seg_t1_masks[idx], seg_t2, seg_t2_mask)
    broadcast_object(ax, ("members", (tree_to(args, "cpu"), kwargs)))
    return sharded_member_predictions(ax, *args, **kwargs)[:e]


class MemberFollower:
    """A rank other than rank 0 of ``ax``: on each ``"members"`` message
    of :func:`lead_members` it runs its share (``parallel.comm.follow``'s
    handler)."""

    def __init__(self, ax: MeshAxis, device: torch.device):
        self.ax, self.device = ax, device

    def __call__(self, kind: str, payload) -> None:
        from .comm import tree_to
        if kind != "members":
            raise ValueError(f"unexpected message {kind!r}")
        args, kwargs = payload
        sharded_member_predictions(self.ax, *tree_to(args, self.device),
                                   **kwargs)
