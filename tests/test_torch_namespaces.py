"""The port's package namespaces against the JAX package's: every name of a
JAX ``__all__`` (the top level's config classes for the package itself)
is bound in the port's namespace of the same name, to a class where JAX's
is a class and to a function where JAX's is a function, but for the names
listed with their reasons.  Then the twins that came with them:
``utils.profiling`` and ``models.FFN`` against JAX's."""

import importlib
import inspect
import io
import contextlib
import time

import jax
import numpy as np
import pytest
import torch

import t3dct  # noqa: F401
import t3dct_torch
from t3dct.models.ffn import FFN as JFFN
from t3dct.utils import profiling as jprof
from t3dct_torch.models import FFN
from t3dct_torch.utils import profiling
from t3dct_torch.utils.timing import CudaStageTimer
from test_torch_scene import to_jax

# JAX's package binds these at its top level (__init__.py:36-46)
TOP_LEVEL = ["ops", "Coordinates", "LcnConfig", "MeshConfig",
             "SegmentationConfig", "StarDistConfig", "TrackingConfig",
             "TrainFfnConfig", "TrainUnetConfig"]
LEFT_OUT = {
    "utils": {"enable_compilation_cache":
              "XLA's compile cache: not to be ported (ROADMAP.md, "
              "'Do not port'); utils.cuda_build caches the kernels"},
    "ops": {"lcn": "ops.lcn stays the module, which the port's callers "
                   "import as such; the function is ops.lcn.lcn"},
}


def kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else type(obj).__name__


@pytest.mark.parametrize("namespace", ["", "engine", "models", "io",
                                       "utils", "ops", "parallel"])
def test_namespace_binds_jax_names(namespace):
    jmod = importlib.import_module("t3dct" + ("." + namespace if namespace
                                              else ""))
    tmod = importlib.import_module("t3dct_torch" + ("." + namespace
                                                    if namespace else ""))
    names = TOP_LEVEL if not namespace else jmod.__all__
    left_out = LEFT_OUT.get(namespace, {})
    assert set(left_out) <= set(names)
    missing = [n for n in names if n not in left_out
               and not hasattr(tmod, n)]
    assert not missing, missing
    wrong = [n for n in names if n not in left_out
             and kind(getattr(tmod, n)) != kind(getattr(jmod, n))]
    assert not wrong, wrong
    if namespace:
        assert sorted(tmod.__all__) == sorted(
            n for n in names if n not in left_out)
    # the examples' own import lines
    if namespace == "engine":
        from t3dct_torch.engine import (  # noqa: F401
            StarDist3D, load_stardist_model, predict_and_save,
            track_timelapse)


def test_every_example_has_a_twin():
    """Each script of ``examples/`` has a twin of its name in the port's
    ``scripts/``, with a ``main(argv)``."""
    from pathlib import Path
    root = Path(t3dct_torch.__file__).resolve().parent
    examples = sorted(p.stem for p in (root.parent / "examples").glob(
        "*.py"))
    assert len(examples) == 8
    for name in examples:
        mod = importlib.import_module(f"t3dct_torch.scripts.{name}")
        assert "argv" in inspect.signature(mod.main).parameters, name


def test_mesh_config_is_jax_s():
    from t3dct.config import MeshConfig as JMeshConfig
    from t3dct_torch.config import MeshConfig
    import dataclasses
    fields = [(f.name, f.default) for f in dataclasses.fields(MeshConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JMeshConfig)]


# ---- utils.profiling -------------------------------------------------------


def test_stage_timer_is_jax_s(monkeypatch):
    """The same totals, counts and summary table as JAX's timer under one
    clock."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    timers = [profiling.StageTimer(), jprof.StageTimer()]
    for timer in timers:
        for name in ("seg", "track", "seg", "io"):
            with timer.stage(name):
                pass
    assert dict(timers[0].totals) == dict(timers[1].totals)
    assert dict(timers[0].counts) == dict(timers[1].counts) == \
        {"seg": 2, "track": 1, "io": 1}
    assert timers[0].summary() == timers[1].summary()


def test_timer_decorator_prints_as_jax_s(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", iter([1.0, 1.5, 2.0, 2.5])
                        .__next__)
    outs = []
    for deco in (profiling.timer, jprof.timer):
        @deco
        def step(x):
            return x + 1
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert step(1) == 2
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == "[step] 0.500s\n"


def test_device_trace(tmp_path):
    """No-op without a directory; with one, a ``torch.profiler`` trace of
    the scope lands there.  ``CudaStageTimer`` is the variant that
    synchronizes the stream."""
    with profiling.device_trace() as prof:
        assert prof is None
    with profiling.device_trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof is not None and any(tmp_path.iterdir())
    assert "synchroniz" in CudaStageTimer.__doc__


# ---- models.FFN ------------------------------------------------------------


def test_ffn_dataclass_matches_jax():
    """``FFN`` carries JAX's widths; its init has JAX's tree and shapes,
    and its apply on the same weights gives JAX's scores (1e-6) and state,
    in eval and train mode."""
    assert (FFN().n_features, FFN().hidden) == (JFFN().n_features,
                                                JFFN().hidden)
    spec = FFN(n_features=5, hidden=16)
    params, state = spec.init(torch.Generator().manual_seed(0), "cpu")
    jparams, jstate = JFFN(5, 16).init(jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, state)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            jstate))
    x = np.random.RandomState(0).randn(12, 10).astype(np.float32)
    for train in (False, True):
        out, new_state = spec.apply(params, state, torch.from_numpy(x),
                                    train)
        jout, jnew = JFFN(5, 16).apply(to_jax(params), to_jax(state), x,
                                       train)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=0, atol=1e-6)
        for k in ("feat_bn", "comb_bn"):
            for s in ("mean", "var"):
                np.testing.assert_allclose(
                    new_state[k][s].detach().numpy(),
                    np.asarray(jnew[k][s]), rtol=1e-5, atol=1e-6)
