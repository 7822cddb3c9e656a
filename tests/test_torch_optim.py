"""The port's Adam (``utils/optim.py``) and checkpoints
(``utils/checkpoint.py``) against optax and the JAX package's
``save_pytree`` / ``load_pytree``, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.models.ffn import FFN
from t3dct.utils.checkpoint import load_pytree as jload
from t3dct.utils.checkpoint import save_pytree as jsave
from t3dct_torch.utils.checkpoint import load_pytree, save_pytree
from t3dct_torch.utils.optim import Adam

# five updates, f32: the moments agree to the ulp, and the bias
# corrections' b**count may part by one ulp (XLA's pow of an integer power)
ADAM_TOL = 1e-6


def _grads(rng, shapes, n):
    return [[rng.randn(*s).astype(np.float32) * 10.0 ** rng.randint(-3, 2)
             for s in shapes] for _ in range(n)]


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("lr", [1e-3, 3e-3])
def test_adam_matches_optax(inject, lr):
    """Five updates of three tensors from the same gradients: optax's
    ``adam`` (or, as the StarDist trainer builds it, under
    ``inject_hyperparams`` with b1, b2 and eps static) against the port."""
    rng = np.random.RandomState(0)
    shapes = [(3, 3, 3, 2, 4), (4,), (7, 5)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = _grads(rng, shapes, 5)
    opt = (optax.inject_hyperparams(optax.adam, static_args=("b1", "b2",
                                                             "eps"))(
        learning_rate=lr) if inject else optax.adam(lr))
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    adam = Adam(tp, lr)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step([torch.from_numpy(x) for x in g])
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=ADAM_TOL, atol=ADAM_TOL)


def test_adam_learning_rate_change_matches_inject_hyperparams():
    """ReduceLROnPlateau's move: the learning rate halves between two
    updates, as the StarDist trainer writes it into optax's state."""
    rng = np.random.RandomState(1)
    shapes = [(6, 2)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = _grads(rng, shapes, 4)
    opt = optax.inject_hyperparams(optax.adam, static_args=(
        "b1", "b2", "eps"))(learning_rate=3e-3)
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    adam = Adam(tp, 3e-3)
    for i, g in enumerate(grads):
        if i == 2:
            state.hyperparams["learning_rate"] = jnp.asarray(1.5e-3,
                                                             jnp.float32)
            adam.learning_rate = 1.5e-3
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step([torch.from_numpy(x) for x in g])
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]),
                               rtol=ADAM_TOL, atol=ADAM_TOL)


def test_adam_bumps_the_version_counter():
    """The update is an in-place write the conv's packed-weight cache
    sees (``w._version`` moves); ``.data`` writes would not move it."""
    w = torch.ones(3, 3, 3, 8, 8, requires_grad=True)
    adam = Adam([w], 1e-3)
    v0 = w._version
    adam.step([torch.ones_like(w)])
    assert w._version > v0
    assert not w.requires_grad or w.grad is None
    assert float(w.detach().max()) < 1.0


def _ffn_tree():
    params, state = FFN().init(jax.random.PRNGKey(3))
    return params, state


def test_checkpoint_port_reads_jax(tmp_path):
    """JAX's ``save_pytree`` of the FFN's (params, state) tuple, read by
    the port into a template of tensors: the same numbers, exactly."""
    tree = _ffn_tree()
    jsave(tree, tmp_path / "ffn.ckpt")
    template = jax.tree_util.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32), tree)
    got = load_pytree(template, tmp_path / "ffn.ckpt")
    flat_j = jax.tree_util.tree_leaves(tree)
    flat_t = jax.tree_util.tree_leaves(got)
    assert len(flat_j) == len(flat_t) == 12
    for a, b in zip(flat_j, flat_t):
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_checkpoint_jax_reads_port(tmp_path):
    """The port's ``save_pytree`` of tensors, read by JAX's ``load_pytree``
    into its own template; the file is written to exactly the path given
    (no ``.npz`` appended)."""
    tree = _ffn_tree()
    ttree = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a) + 1.0), tree)
    path = tmp_path / "weights_training__epoch1.ckpt"
    save_pytree(ttree, path)
    assert path.exists() and not path.with_suffix(".ckpt.npz").exists()
    got = jload(tree, path)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_checkpoint_load_raises_on_a_missing_or_misshapen_leaf(tmp_path):
    save_pytree({"a": torch.zeros(2), "b": {"c": torch.ones(3)}},
                tmp_path / "t.npz")
    with pytest.raises(KeyError, match="missing leaf b/d"):
        load_pytree({"b": {"d": torch.zeros(3)}}, tmp_path / "t.npz")
    with pytest.raises(ValueError, match="leaf a"):
        load_pytree({"a": torch.zeros(3)}, tmp_path / "t.npz")
