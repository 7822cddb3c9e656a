"""The whole public surface of the JAX package against the port.

Every module of the JAX package (each one a case) has a twin at the same
path in the port.  Every public function and class defined there, every
public method of such a class and ``__init__``, is bound in the twin under
the same name, and binds the same parameter names, in the same order, of
the same kinds, with the same plain defaults (``None``, bools, numbers,
strings, tuples); the port may add parameters after JAX's, keyword-only.
Every public module-level assignment is bound too, with the same value
where it is a plain value.  The differences that remain are the short
tables below, each entry with its reason.  Then JAX's positional calls of
the operator library bind the same parameters in the port."""

import ast
import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import t3dct  # noqa: E402
import t3dct_torch  # noqa: E402

JAX_ROOT = t3dct.__name__
PORT_ROOT = t3dct_torch.__name__

# JAX modules the port has under another path, or not at all
MODULES_ELSEWHERE = {
    "native": ("io.tiff", "the TIFF codec's loader; the port builds its "
               "own copy of the codec there"),
    "native.tiff": ("io.tiff", "the same codec and readers"),
    "ops.pallas_conv": ("ops.hopper_conv", "a Pallas TPU kernel; the "
                        "port's is a hand-written CUDA kernel"),
    "ops.pallas_kernels": ("ops.hopper_flood", "Pallas TPU kernels; the "
                           "port's flood and components kernels are "
                           "ops.hopper_flood and ops.hopper_cc"),
    "ops.rle": (None, "ROADMAP.md 'Do not port': a TPU transfer format "
                "that no path of the port reads"),
}
# JAX names the port does not bind
NAMES_LEFT_OUT = {
    ("models.layers", "DIMNUMS_3D"): "XLA's conv dimension numbers; the "
                                     "port's convs take their layouts "
                                     "directly",
}
# a torch.Generator takes the place of JAX's PRNG key, in every signature
RENAMED = {"key": "generator"}

PLAIN = (type(None), bool, int, float, str, tuple)


def jax_modules():
    """Every public module of the JAX package, relative to its root."""
    names = []
    for info in pkgutil.walk_packages(t3dct.__path__, JAX_ROOT + "."):
        rel = info.name[len(JAX_ROOT) + 1:]
        if not any(part.startswith("_") for part in rel.split(".")):
            names.append(rel)
    return sorted(names)


MODULES = jax_modules()


def module_pair(rel):
    return (importlib.import_module(f"{JAX_ROOT}.{rel}"),
            importlib.import_module(f"{PORT_ROOT}.{rel}"))


def assigned_names(module):
    """The public names a module's source assigns at its top level."""
    names = []
    for node in ast.parse(inspect.getsource(module)).body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        names += [t.id for t in targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_") and n != "__all__"]


def defined_callables(module):
    """The public functions and classes defined in ``module`` (jitted
    functions included)."""
    return {n: obj for n, obj in vars(module).items()
            if not n.startswith("_") and callable(obj)
            and getattr(obj, "__module__", None) == module.__name__}


def public_members(cls):
    """``__init__`` and the public names a class defines itself."""
    return [n for n in vars(cls) if n == "__init__"
            or not n.startswith("_")]


def signature_problems(jfn, tfn):
    """How ``tfn``'s parameters fail to bind ``jfn``'s (empty: they
    bind)."""
    want = list(inspect.signature(jfn).parameters.values())
    got = list(inspect.signature(tfn).parameters.values())
    names = [RENAMED.get(p.name, p.name) for p in want]
    if [p.name for p in got[:len(want)]] != names:
        return [f"names {[p.name for p in got]} != {names}"]
    out = [f"{p.name} not keyword-only" for p in got[len(want):]
           if p.kind is not inspect.Parameter.KEYWORD_ONLY]
    for w, g in zip(want, got):
        if g.kind != w.kind:
            out.append(f"{w.name}: kind {g.kind} != {w.kind}")
        if (g.default is inspect.Parameter.empty) != \
                (w.default is inspect.Parameter.empty):
            out.append(f"{w.name}: default {g.default!r} vs {w.default!r}")
        elif isinstance(w.default, PLAIN) and g.default != w.default:
            out.append(f"{w.name}: default {g.default!r} != {w.default!r}")
    return out


def plain_equal(a, b):
    try:
        return bool(np.all(a == b)) and type(a) is type(b)
    except Exception:
        return False


@pytest.mark.parametrize("rel", MODULES)
def test_module_binds_jax_surface(rel):
    if rel in MODULES_ELSEWHERE:
        elsewhere, _ = MODULES_ELSEWHERE[rel]
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"{PORT_ROOT}.{rel}")
        if elsewhere is not None:
            importlib.import_module(f"{PORT_ROOT}.{elsewhere}")
        return
    jmod, tmod = module_pair(rel)
    problems = []
    for name, jobj in defined_callables(jmod).items():
        if not hasattr(tmod, name):
            problems.append(f"{name}: missing")
            continue
        tobj = getattr(tmod, name)
        if inspect.isclass(jobj) != inspect.isclass(tobj):
            problems.append(f"{name}: class in one package only")
            continue
        pairs = [(name, jobj, tobj)]
        if inspect.isclass(jobj):
            pairs = []
            for member in public_members(jobj):
                jm = getattr(jobj, member)
                if not hasattr(tobj, member):
                    problems.append(f"{name}.{member}: missing")
                elif callable(jm) and not inspect.isclass(jm):
                    pairs.append((f"{name}.{member}", jm,
                                  getattr(tobj, member)))
                elif isinstance(jm, PLAIN) and \
                        getattr(tobj, member) != jm:
                    problems.append(f"{name}.{member}: value differs")
        for qual, jfn, tfn in pairs:
            problems += [f"{qual}: {p}" for p in signature_problems(jfn,
                                                                    tfn)]
    for name in assigned_names(jmod):
        if (rel, name) in NAMES_LEFT_OUT:
            assert not hasattr(tmod, name), f"{name} is bound now"
            continue
        if not hasattr(tmod, name):
            problems.append(f"{name}: missing")
        elif isinstance(getattr(jmod, name), PLAIN) and not plain_equal(
                getattr(tmod, name), getattr(jmod, name)):
            problems.append(f"{name}: value differs")
    assert not problems, problems


def test_exception_tables_are_current():
    """Each table entry names a JAX module or name that exists and that
    the port still lacks."""
    assert set(MODULES_ELSEWHERE) <= set(MODULES)
    for rel, name in NAMES_LEFT_OUT:
        assert hasattr(importlib.import_module(f"{JAX_ROOT}.{rel}"), name)
    assert len(MODULES) > 50


# JAX's positional calls of the operator library
POSITIONAL = [
    ("ops.edt", "distance_transform_edt", ("m", None, 5)),
    ("ops.filters", "gaussian_filter", ("x", 1.5, "zero")),
    ("ops.filters", "gaussian_filter", ("x", 1.5, "mirror", 3.0)),
    ("ops.peaks", "peak_local_max_mask", ("x", 1, None, 0.5)),
    ("ops.nms", "overlap_matrix", ("c", "d", "r", "v", 128, 8)),
    ("ops.connected", "label_components", ("m", None, 4096, 12)),
    ("ops.connected", "label_components_raw", ("m", 2, 8)),
    ("ops.subregions", "move_cells_full", ("a", "mv", "inc", "last",
                                           "drop")),
    ("ops.lcn", "lcn", ("x", 5.0, (27, 27, 1), "reflect")),
    ("ops.lcn", "normalize_image", ("x", 5.0, (27, 27, 1), "reflect", 61)),
    ("ops.stardist_gt", "star_dist3d", ("lab", "rays", 32, 8)),
    ("models.ffn", "ffn_pair_scores", ("p", "s", "r", "t", 64)),
]


@pytest.mark.parametrize("rel,name,args", POSITIONAL,
                         ids=[f"{r}.{n}" for r, n, _ in POSITIONAL])
def test_jax_positional_call_binds_the_same(rel, name, args):
    jmod, tmod = module_pair(rel)
    want = inspect.signature(getattr(jmod, name)).bind(*args).arguments
    got = inspect.signature(getattr(tmod, name)).bind(*args).arguments
    assert dict(got) == dict(want)
