"""FFN point-pair matching network (counterpart of
``3deecelltracker_tpu/models/ffn.py``: ``FFN``, ``init_ffn``, ``ffn_apply``,
``ffn_pair_scores``).

A shared trunk Dense(61->512, no bias) -> BN -> LeakyReLU on each half of
a pair, concat -> Dense(512, no bias) -> BN -> LeakyReLU -> Dense(1) ->
sigmoid.  Eval mode, and train mode (batch statistics) for the trainer.
Params ``{"feat", "comb", "pred", "feat_bn",
"comb_bn"}``, state ``{"feat_bn", "comb_bn"}`` with ``mean``/``var``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..utils.device import select_device
from . import layers as L

N_FEATURES = 61
HIDDEN = 512
# the largest (E, m, n, hidden) pair tensor scored in one batch; a legacy
# ensemble (20 members padded to 512 cells) runs member by member
MAX_PAIR_ELEMENTS = 1 << 30

Params = Dict[str, Any]
State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FFN:
    """The network's widths with its init and apply (JAX ``models/ffn.py:
    39-61``)."""
    n_features: int = N_FEATURES
    hidden: int = HIDDEN

    def init(self, generator: torch.Generator, *, device=None
             ) -> Tuple[Params, State]:
        """``(params, state)``: :func:`init_ffn` at these widths."""
        return init_ffn(generator, device=device,
                        n_features=self.n_features, hidden=self.hidden)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              train: bool = False) -> Tuple[torch.Tensor, State]:
        """Pairwise forward on (batch, 2 * n_features) rows -> ``((batch,
        1) scores, state)``, the state moved in train mode (JAX's
        ``FFN.apply``)."""
        out = ffn_apply(params, state, x, train, n_features=self.n_features)
        return out if train else (out, state)


def init_ffn(generator: torch.Generator, *, device=None,
             n_features: int = N_FEATURES, hidden: int = HIDDEN
             ) -> Tuple[Params, State]:
    """Seeded glorot init with identity batchnorms (JAX's tree, not JAX's
    numbers); ``device=None`` is the card."""
    device = select_device(device)
    params = {"feat": L.init_dense(generator, n_features, hidden,
                                   use_bias=False, device=device),
              "comb": L.init_dense(generator, 2 * hidden, hidden,
                                   use_bias=False, device=device),
              "pred": L.init_dense(generator, hidden, 1, device=device)}
    state = {}
    params["feat_bn"], state["feat_bn"] = L.init_bn(hidden, device=device)
    params["comb_bn"], state["comb_bn"] = L.init_bn(hidden, device=device)
    return params, state


def feature_distance_ffn(generator: torch.Generator, device=None
                         ) -> Tuple[Params, Params]:
    """Seeded weights for which the network scores a pair by how alike
    its two feature vectors are: ``sigmoid(4 - c * |(f_ref - f_tgt) W|_1)``
    for a random projection W (c = 0.05 times the two LeakyReLU slopes).  The trunk and the combine layer use +/- weight pairs, so
    that ``leaky(u) - leaky(-u)`` and ``leaky(v) + leaky(-v)`` are linear
    in u and |v|.  It stands in for trained weights where a run needs a
    matching that follows the cells (tests, the chip smoke run).
    ``device=None`` is the card."""
    device = select_device(device)
    half = HIDDEN // 2
    w1 = torch.randn((N_FEATURES, half), generator=generator) \
        / N_FEATURES ** 0.5
    q = torch.randn((half, half), generator=generator) / half ** 0.5
    feat_w = torch.cat([w1, -w1], dim=1)                     # (61, hidden)
    p = torch.cat([torch.cat([q, -q], dim=1),
                   torch.cat([-q, q], dim=1)], dim=0)        # (hidden, hidden)
    comb_w = torch.cat([p, -p], dim=0)                       # (2*hidden, hidden)
    params, state = init_ffn(generator, device=device)
    params["feat"]["w"] = feat_w.to(device)
    params["comb"]["w"] = comb_w.to(device)
    params["pred"]["w"] = torch.full((HIDDEN, 1), -0.05, device=device)
    params["pred"]["b"] = torch.full((1,), 4.0, device=device)
    return params, state


def ffn_apply(params: Params, state: State, x: torch.Tensor,
              train: bool = False, n_features: int = N_FEATURES, *,
              group=None):
    """Forward on (batch, 2*n_features) pair rows -> (batch, 1) scores.
    ``train=True`` normalizes with the batch's statistics (the trunk's
    batchnorm over both halves at once, as JAX's ``ffn_apply``) and
    returns ``(scores, new_state)``; eval mode returns the scores.
    ``group`` (train mode): the mesh axis (``parallel.mesh.MeshAxis``)
    whose ranks hold the batch's rows; the batchnorms' statistics are the
    whole batch's (``layers.batchnorm``)."""
    new_state = dict(state)

    def bn(name, h):
        if not train:
            return L.batchnorm(params[name], state[name], h, False)
        h, new_state[name] = L.batchnorm(params[name], state[name], h,
                                         train=True, group=group)
        return h

    a = L.dense(params["feat"], x[:, :n_features])
    b = L.dense(params["feat"], x[:, n_features:])
    both = L.leaky_relu(bn("feat_bn", torch.cat([a, b], dim=0)))
    a, b = torch.chunk(both, 2, dim=0)
    h = L.dense(params["comb"], torch.cat([a, b], dim=1))
    h = L.leaky_relu(bn("comb_bn", h))
    out = torch.sigmoid(L.dense(params["pred"], h))
    return (out, new_state) if train else out


def ffn_pair_scores(params: Params, state: State,
                    ref_feats: torch.Tensor, tgt_feats: torch.Tensor,
                    row_chunk: int = 0) -> torch.Tensor:
    """(m_tgt, n_ref) scores of all pairs: the trunk runs once per set and
    the combine layer splits into ref/tgt halves (eval-mode BN is
    affine).  With a leading member axis ((E, n, 61) features), (E, m, n)
    scores, each member's as it is alone; a batch whose pair tensor would
    pass ``MAX_PAIR_ELEMENTS`` runs member by member.  ``row_chunk`` > 0
    scores that many target rows at a time, which bounds the pair tensor
    held at once; the scores equal the whole batch's within float32
    rounding."""
    def trunk(f):
        return L.leaky_relu(L.batchnorm(params["feat_bn"], state["feat_bn"],
                                        L.dense(params["feat"], f), False))

    fr = trunk(ref_feats)
    ft = trunk(tgt_feats)
    w = params["comb"]["w"]
    h_trunk = fr.shape[-1]
    zr = fr @ w[:h_trunk]
    zt = ft @ w[h_trunk:]
    bn_p, bn_s = params["comb_bn"], state["comb_bn"]
    inv = torch.rsqrt(bn_s["var"] + L.BN_EPS) * bn_p["scale"]
    shift = bn_p["bias"] - bn_s["mean"] * inv
    w_pred = params["pred"]["w"][:, 0]
    b_pred = params["pred"]["b"][0]

    def rows(zt, zr):
        z = zt[..., :, None, :] + zr[..., None, :, :]     # (m, n, hidden)
        h = L.leaky_relu(z * inv + shift)
        logits = torch.einsum("...mnc,c->...mn", h, w_pred) + b_pred
        return torch.sigmoid(logits)

    def scores(zt, zr):
        if row_chunk and row_chunk < zt.shape[-2]:
            return torch.cat([rows(c, zr) for c in
                              torch.split(zt, int(row_chunk), dim=-2)],
                             dim=-2)
        return rows(zt, zr)

    if zr.dim() == 3 and zr.shape[0] * zt.shape[-2] * zr[0].numel() > \
            MAX_PAIR_ELEMENTS:
        return torch.stack([scores(zt[i] if zt.dim() == 3 else zt, zr[i])
                            for i in range(zr.shape[0])])
    return scores(zt, zr)
