"""Keras ``.h5`` checkpoints of the reference, read into the port's weight
trees (counterpart of ``3deecelltracker_tpu/utils/keras_import.py``).

The reference ships every pretrained model as Keras HDF5: full-model files
(``keras.models.load_model``, ``tracker.py:930-942,1121``,
``stardistwrapper.py:39-43``) and weights-only files (``load_weights``,
``tracker.py:991,1039-1041``, ``ffn.py:211-220``, ``unet3d.py:559,587``).
This module reads both Keras-2 layouts with ``h5py`` alone (no
TensorFlow):

- full-model files: a ``model_weights`` group and a ``model_config``
  attribute (what TF 2.5/2.11 ``model.save`` writes; Keras 3's legacy
  ``.h5`` saver writes the same);
- weights-only files: ``layer_names`` at the root (``save_weights``).

The importers return trees of float32 numpy arrays keyed as the JAX
package's pytrees, which ``utils.convert`` carries to tensors on a device.
Keras shares the port's layouts, so nothing is transposed: Conv3D kernels
are (k1, k2, k3, c_in, c_out) over channels-last data, Dense kernels
(d_in, d_out), BatchNormalization stores (gamma, beta, moving_mean,
moving_variance).  ``h5py`` is imported only when a file is read; without
it every reader raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import StarDistConfig
from ..io.imageio import import_h5py
from .device import select_device

__all__ = [
    "read_keras_h5",
    "import_unet3",
    "import_ffn",
    "import_stardist3d",
    "stardist_config_from_json",
    "KerasGraph",
]


# ---- the reader ----------------------------------------------------------

def _dec(s) -> str:
    return s.decode("utf8") if isinstance(s, bytes) else str(s)


def read_keras_h5(path: Union[str, Path]
                  ) -> Tuple[List[Tuple[str, List[Tuple[str, np.ndarray]]]],
                             Optional[dict]]:
    """A Keras-2 ``.h5`` file as ``(layers, model_config)``: ``layers`` is
    the ordered ``[(layer_name, [(weight_name, array), ...]), ...]`` in
    saved layer order (build order for functional models), each layer's
    weights in its ``weight_names`` order; layers without weights are
    dropped.  ``model_config`` is the parsed architecture of a full-model
    file, else None."""
    h5py = import_h5py()
    with h5py.File(str(path), "r") as f:
        group = f["model_weights"] if "model_weights" in f else f
        if "layer_names" not in group.attrs:
            raise ValueError(
                f"{path}: no 'layer_names' attribute — not a Keras-2-format "
                "h5 (Keras 3 '.weights.h5' files are not produced by the "
                "reference and are unsupported; re-save via the legacy "
                "'.h5' path)")
        layers = []
        for raw_name in group.attrs["layer_names"]:
            lname = _dec(raw_name)
            grp = group[lname]
            wnames = [_dec(w) for w in grp.attrs.get("weight_names", [])]
            if not wnames:
                continue
            layers.append((lname, [(w, np.asarray(grp[w])) for w in wnames]))
        model_config = None
        cfg_attr = f.attrs.get("model_config")
        if cfg_attr is not None:
            model_config = json.loads(_dec(cfg_attr))
    return layers, model_config


def _units(layers) -> List[Dict[str, Any]]:
    """The saved weights as ordered typed units: ``conv`` / ``dense``
    (``w``, ``b`` or None) and ``bn`` (gamma, beta, moving_mean,
    moving_variance)."""
    units: List[Dict[str, Any]] = []
    for lname, weights in layers:
        for wname, arr in weights:
            base = wname.rsplit("/", 1)[-1].split(":")[0]
            if base == "kernel":
                kind = "conv" if arr.ndim == 5 else "dense"
                units.append({"kind": kind, "w": arr, "b": None,
                              "layer": lname, "name": wname})
            elif base == "bias":
                if not units or units[-1]["kind"] == "bn" \
                        or units[-1]["b"] is not None:
                    raise ValueError(f"{wname}: bias with no pending kernel")
                units[-1]["b"] = arr
            elif base == "gamma":
                units.append({"kind": "bn", "gamma": arr, "layer": lname,
                              "name": wname})
            elif base in ("beta", "moving_mean", "moving_variance"):
                # a new unit unless this weight continues the bn unit of
                # the same layer: a scale=False bn (no gamma) right after
                # a complete one must not overwrite its statistics
                if (not units or units[-1]["kind"] != "bn"
                        or units[-1]["layer"] != lname
                        or base in units[-1]):
                    units.append({"kind": "bn", "layer": lname,
                                  "name": wname})
                units[-1][base] = arr
            else:
                raise ValueError(f"unrecognized Keras weight '{wname}' "
                                 f"(shape {arr.shape})")
    return units


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _conv_params(u: Dict[str, Any],
                 expect: Optional[Tuple[int, int]] = None,
                 kernel: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    w = u["w"]
    if expect is not None and tuple(w.shape[-2:]) != tuple(expect):
        raise ValueError(
            f"{u['name']}: kernel channels {w.shape[-2:]} != expected "
            f"{expect} — wrong architecture/variant for this file")
    if kernel is not None and tuple(w.shape[:3]) != tuple(kernel):
        raise ValueError(f"{u['name']}: kernel size {w.shape[:3]} != "
                         f"expected {tuple(kernel)}")
    p = {"w": _f32(w)}
    if u["b"] is not None:
        p["b"] = _f32(u["b"])
    return p


def _bn_params(u: Dict[str, Any], c: int):
    mean = u.get("moving_mean")
    var = u.get("moving_variance")
    if mean is None or var is None or mean.shape != (c,):
        raise ValueError(f"{u.get('name')}: malformed BatchNorm weights")
    gamma = u.get("gamma", np.ones(c, np.float32))
    beta = u.get("beta", np.zeros(c, np.float32))
    return ({"scale": _f32(gamma), "bias": _f32(beta)},
            {"mean": _f32(mean), "var": _f32(var)})


# ---- U-Net 3 (a/b/c) -----------------------------------------------------

def _unet_block_specs(spec) -> List[Tuple[str, int, int]]:
    """(name, c_in, c_out) of every conv block in build order (the
    reference's ``_unet3_depth3``, unet3d.py:84-98): down blocks, up blocks
    (conv, then upsample), head, the 1x1x1 output conv."""
    plan, c = spec.block_plan()
    return list(plan) + [("out", c, 1)]


def import_unet3(path: Union[str, Path], variant: Optional[str] = None):
    """A reference 3D U-Net checkpoint (full-model or weights-only ``.h5``;
    ``tracker.py:579,991``, ``unet3d.py:559``) as ``(spec, params,
    state)``: ``spec`` the :class:`~..models.unet3d.UNet3D` (inferred from
    the weight shapes when ``variant`` is None), and numpy trees that
    ``utils.convert.unet_from_numpy`` carries to a device.  Variants 'a'
    and 'c' have the same weight shapes (they differ only in pooling), so
    inference resolves that tie to 'a'; pass ``variant='c'`` for isotropic
    models."""
    from ..models.unet3d import get_unet

    layers, _ = read_keras_h5(path)
    units = _units(layers)
    convs = [u for u in units if u["kind"] == "conv"]
    bns = [u for u in units if u["kind"] == "bn"]
    if any(u["kind"] == "dense" for u in units):
        raise ValueError(f"{path}: found Dense weights — not a U-Net file")

    candidates = [variant] if variant else ["a", "b", "c"]
    last_err: Optional[Exception] = None
    for var in candidates:
        spec = get_unet(var)
        blocks = _unet_block_specs(spec)
        if len(convs) != len(blocks) or len(bns) != len(blocks) - 1:
            last_err = ValueError(
                f"{path}: {len(convs)} convs / {len(bns)} BNs vs "
                f"{len(blocks)} expected for variant '{var}'")
            continue
        try:
            params: Dict[str, Any] = {}
            state: Dict[str, Any] = {}
            for i, (name, cin, cout) in enumerate(blocks):
                kern = (1, 1, 1) if name == "out" else (3, 3, 3)
                params[name] = {"conv": _conv_params(convs[i], (cin, cout),
                                                     kern)}
                if name != "out":
                    params[name]["bn"], state[name] = _bn_params(bns[i],
                                                                 cout)
            return spec, params, state
        except ValueError as e:
            last_err = e
    raise ValueError(f"{path}: could not match any unet3 variant "
                     f"({candidates}): {last_err}")


# ---- FFN (v1.0, ffn.py:225-265) ------------------------------------------

def import_ffn(path: Union[str, Path]):
    """An FFN checkpoint of the reference's trainer (``ffn.py:211-220``
    save_weights, ``trackerlite.py:63`` load_weights) as ``(params,
    state)`` numpy trees for ``models.ffn`` (``utils.convert.
    ffn_from_numpy``).  Expected units: Dense(n_feat -> 512, no bias),
    BN(512), Dense(1024 -> 512, no bias), BN(512), Dense(512 -> 1)."""
    layers, _ = read_keras_h5(path)
    units = _units(layers)
    kinds = [u["kind"] for u in units]
    if kinds != ["dense", "bn", "dense", "bn", "dense"]:
        raise ValueError(f"{path}: unit sequence {kinds} does not match the "
                         "FFN architecture (ffn.py:225-265)")
    feat, feat_bn, comb, comb_bn, pred = units
    hidden = feat["w"].shape[1]
    if comb["w"].shape[0] != 2 * hidden or pred["w"].shape != (hidden, 1):
        raise ValueError(f"{path}: inconsistent FFN widths "
                         f"{[u['w'].shape for u in (feat, comb, pred)]}")
    params = {"feat": _conv_params(feat),
              "comb": _conv_params(comb),
              "pred": _conv_params(pred)}
    state: Dict[str, Any] = {}
    params["feat_bn"], state["feat_bn"] = _bn_params(feat_bn, hidden)
    params["comb_bn"], state["comb_bn"] = _bn_params(comb_bn, hidden)
    return params, state


# ---- StarDist3D ----------------------------------------------------------

def import_stardist3d(path: Union[str, Path], config: StarDistConfig):
    """A stardist-0.8 Keras checkpoint (``weights_best.h5`` of a model
    folder; ``stardistwrapper.py:39-43``) as the numpy params of
    ``StarDist3DNet(config, arch="keras")``.  The file's convs are in
    creation order (pre-grid blocks, csbdeep ``unet_block``, ``features``,
    ``prob``, ``dist``), which is ``StarDist3DNet._keras_plan``; each kernel
    is shape-checked against it, so a config that does not fit the file
    raises."""
    from ..models.stardist3d import StarDist3DNet

    layers, _ = read_keras_h5(path)
    units = _units(layers)
    if any(u["kind"] == "bn" for u in units):
        raise ValueError(f"{path}: BatchNorm weights present — "
                         "unet_batch_norm=True checkpoints are unsupported")
    convs = [u for u in units if u["kind"] == "conv"]
    plan = StarDist3DNet(config, arch="keras")._keras_plan()
    if len(convs) != len(plan):
        raise ValueError(f"{path}: {len(convs)} conv layers vs {len(plan)} "
                         f"expected from config (grid={config.grid}, "
                         f"depth={config.unet_n_depth})")
    return {name: _conv_params(u, (cin, cout), kernel)
            for u, (name, cin, cout, kernel) in zip(convs, plan)}


def stardist_config_from_json(path: Union[str, Path]) -> StarDistConfig:
    """A stardist model folder's ``config.json`` (written by ``Config3D``)
    as a :class:`StarDistConfig`."""
    with open(path) as fh:
        raw = json.load(fh)
    if raw.get("backbone", "unet") != "unet":
        raise ValueError(f"unsupported stardist backbone "
                         f"{raw.get('backbone')!r}")
    if raw.get("unet_batch_norm", False):
        raise ValueError("unet_batch_norm=True is unsupported")
    n_rays = raw.get("n_rays")
    if n_rays is None:
        n_rays = raw.get("rays_json", {}).get("kwargs", {}).get("n", 96)
    anisotropy = raw.get("anisotropy") or (1.0, 1.0, 1.0)

    def tup(key, default):
        v = raw.get(key, default)
        return tuple(v) if v is not None else default

    return StarDistConfig(
        n_rays=int(n_rays),
        grid=tup("grid", (1, 1, 1)),
        anisotropy=tuple(float(a) for a in anisotropy),
        unet_n_depth=int(raw.get("unet_n_depth", 2)),
        unet_pool=tup("unet_pool", (2, 2, 2)),
        unet_n_filter_base=int(raw.get("unet_n_filter_base", 32)),
        unet_n_conv_per_depth=int(raw.get("unet_n_conv_per_depth", 2)),
        unet_kernel_size=tup("unet_kernel_size", (3, 3, 3)),
        net_conv_after_unet=int(raw.get("net_conv_after_unet", 128)),
        n_channel_in=int(raw.get("n_channel_in", 1)),
        train_patch_size=tup("train_patch_size", (48, 96, 96)),
    )


# ---- the Keras-2 functional-graph executor (legacy full-model files) -----

class KerasGraph:
    """Inference executor for Keras-2 ``model_config`` graphs over the MLP
    layer family: InputLayer, Dense, BatchNormalization, LeakyReLU, ReLU,
    Activation, Concatenate, Dropout, Add, Flatten.  It runs the
    reference's legacy FFN full-model files (``tracker.py:1121``: the
    two-input model of ``track.initial_matching_quick``, track.py:117-180,
    whose architecture exists only inside the file) without TensorFlow.

    Runs in float32 on ``device`` (the card by default); inference
    semantics (Dropout is the identity, BatchNorm uses the moving
    statistics).  Inputs are arrays or tensors; outputs are tensors on the
    device."""

    def __init__(self, model_config: dict,
                 layer_weights: Dict[str, List[Tuple[str, np.ndarray]]],
                 *, device=None):
        cfg = model_config.get("config", model_config)
        if isinstance(cfg, dict) and "layers" not in cfg:
            raise ValueError("model_config has no layers")
        if model_config.get("class_name") == "Sequential" or not any(
                "inbound_nodes" in lay for lay in cfg["layers"]):
            # a Sequential config has no inbound_nodes graph: only the
            # first layer would be seeded, and the output lookup would
            # fail far from the cause
            raise ValueError(
                "Sequential-format model_config is not supported by "
                "KerasGraph (no inbound_nodes graph); re-save the model "
                "in functional form or use the explicit architecture "
                "importers (import_unet3 / import_ffn)")
        self.device = select_device(device)
        self.layers = {}
        self.order: List[str] = []
        for lay in cfg["layers"]:
            name = lay.get("name") or lay["config"].get("name")
            self.layers[name] = lay
            self.order.append(name)
        self.input_names = [spec[0] for spec in cfg["input_layers"]] \
            if "input_layers" in cfg else [self.order[0]]
        self._output_specs = cfg.get("output_layers", [self.order[-1]])
        self.weights = {
            name: [{k: self._tensor(v) if isinstance(v, np.ndarray) else v
                    for k, v in u.items()} for u in _units([(name, w)])]
            for name, w in layer_weights.items()}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    @classmethod
    def from_h5(cls, path: Union[str, Path], *,
                device=None) -> "KerasGraph":
        layers, model_config = read_keras_h5(path)
        if model_config is None:
            raise ValueError(f"{path}: no model_config — a weights-only "
                             "file needs an explicit architecture importer")
        return cls(model_config, dict(layers), device=device)

    # -- layer semantics ----------------------------------------------------
    @staticmethod
    def _activation(name: str, x: torch.Tensor) -> torch.Tensor:
        if name in (None, "linear"):
            return x
        if name == "relu":
            return torch.relu(x)
        if name == "sigmoid":
            return torch.sigmoid(x)
        if name == "tanh":
            return torch.tanh(x)
        raise ValueError(f"unsupported activation {name!r}")

    def _run_layer(self, lay: dict, inputs: List[torch.Tensor]
                   ) -> torch.Tensor:
        cls_name = lay["class_name"]
        cfg = lay["config"]
        name = lay.get("name") or cfg.get("name")
        units = self.weights.get(name, [])
        if cls_name == "InputLayer":
            return inputs[0]
        if cls_name == "Dense":
            (u,) = units
            y = inputs[0] @ u["w"]
            if u["b"] is not None:
                y = y + u["b"]
            return self._activation(cfg.get("activation"), y)
        if cls_name == "BatchNormalization":
            (u,) = units
            c = u["moving_mean"].shape[0]
            eps = float(cfg.get("epsilon", 1e-3))
            gamma = u.get("gamma", torch.ones(c, device=self.device))
            beta = u.get("beta", torch.zeros(c, device=self.device))
            inv = gamma / torch.sqrt(u["moving_variance"] + eps)
            return (inputs[0] - u["moving_mean"]) * inv + beta
        if cls_name == "LeakyReLU":
            alpha = float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))
            x = inputs[0]
            return torch.where(x >= 0, x, alpha * x)
        if cls_name == "ReLU":
            return torch.relu(inputs[0])
        if cls_name == "Activation":
            return self._activation(cfg.get("activation"), inputs[0])
        if cls_name == "Concatenate":
            return torch.cat(inputs, dim=int(cfg.get("axis", -1)))
        if cls_name == "Add":
            return sum(inputs[1:], inputs[0])
        if cls_name == "Dropout":
            return inputs[0]
        if cls_name == "Flatten":
            x = inputs[0]
            return x.reshape(x.shape[0], -1)
        raise ValueError(f"unsupported Keras layer {cls_name!r} ({name})")

    def __call__(self, *inputs) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Run the graph.  Values are keyed by (layer_name, node_index), so
        a shared layer (one layer at several graph positions, e.g. the
        legacy FFN's feature branch applied to both inputs) works; pending
        nodes resolve by fixed-point iteration."""
        if len(inputs) != len(self.input_names):
            raise ValueError(f"model expects {len(self.input_names)} "
                             f"inputs, got {len(inputs)}")
        values: Dict[Tuple[str, int], torch.Tensor] = {
            (name, 0): torch.as_tensor(x, dtype=torch.float32).to(
                self.device)
            for name, x in zip(self.input_names, inputs)}
        pending = [(name, idx, node)
                   for name in self.order
                   for idx, node in
                   enumerate(self.layers[name].get("inbound_nodes", []))]
        while pending:
            progressed = False
            remaining = []
            for name, idx, node in pending:
                parents = [(_dec(spec[0]), int(spec[1])) for spec in node]
                if all(p in values for p in parents):
                    values[(name, idx)] = self._run_layer(
                        self.layers[name], [values[p] for p in parents])
                    progressed = True
                else:
                    remaining.append((name, idx, node))
            if not progressed:
                raise ValueError(
                    "graph has unresolvable node dependencies: "
                    f"{[(n, i) for n, i, _ in remaining]}")
            pending = remaining
        outs = [values[(spec[0], spec[1]) if isinstance(spec, (list, tuple))
                       else (spec, 0)]
                for spec in self._output_specs]
        return outs[0] if len(outs) == 1 else outs
