"""Weights for the port: the JAX package's params tree as a state dict, and
seeded random weights.

`jax_params_to_state_dict` inverts the layout changes of the JAX package's
torch importer (conv (O, I, kh, kw) -> (kh, kw, I, O), linear (O, I) ->
(I, O)). It keeps its own copy of the name table, since the port cannot
import the JAX package, and raises on any leaf it does not use, so every
parameter of the port is set exactly once.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _encoder_entries(prefix: str):
    """One BasicEncoder4Evs (extractor.py:269-335)."""
    fprefix = prefix.replace(".", "/")
    out = {f"{prefix}.conv1": (f"{fprefix}/conv1", "conv"),
           f"{prefix}.conv2": (f"{fprefix}/conv2", "conv")}
    for layer in ("layer1", "layer2"):
        for b in range(2):
            t, f = f"{prefix}.{layer}.{b}", f"{fprefix}/{layer}_{b}"
            out[f"{t}.conv1"] = (f"{f}/conv1", "conv")
            out[f"{t}.conv2"] = (f"{f}/conv2", "conv")
            # only strided / widening blocks hold the 1x1 downsample conv
            out[f"{t}.downsample.0"] = (f"{f}/downsample", "conv")
    return out


def build_mapping(scorer: bool = True) -> Dict[str, tuple]:
    """torch module path -> (flax module path, kind). `scorer`: whether the
    network holds the scorer (patch_selector="scorer" alone does)."""
    m = {}
    m.update(_encoder_entries("patchify.fnet"))
    m.update(_encoder_entries("patchify.inet"))
    if scorer:
        for i in (0, 2, 4, 6):
            m[f"patchify.scorer.scorer.{i}"] = (f"patchify/scorer/scorer_{i}",
                                                "conv")
    for i in (0, 2, 5):
        m[f"update.corr.{i}"] = (f"update/corr_{i}", "linear")
    m["update.corr.3"] = ("update/corr_3", "norm")
    m["update.norm"] = ("update/norm", "norm")
    for c in ("c1", "c2"):
        m[f"update.{c}.0"] = (f"update/{c}_0", "linear")
        m[f"update.{c}.2"] = (f"update/{c}_2", "linear")
    for agg in ("agg_kk", "agg_ij"):
        for p in ("f", "g", "h"):
            m[f"update.{agg}.{p}"] = (f"update/{agg}/{p}", "linear")
    m["update.gru.0"] = ("update/gru_0", "norm")
    m["update.gru.2"] = ("update/gru_2", "norm")
    for g in (1, 3):
        m[f"update.gru.{g}.gate.0"] = (f"update/gru_{g}/gate_0", "linear")
        m[f"update.gru.{g}.res.0"] = (f"update/gru_{g}/res_0", "linear")
        m[f"update.gru.{g}.res.2"] = (f"update/gru_{g}/res_2", "linear")
    m["update.d.1"] = ("update/d_1", "linear")
    m["update.w.1"] = ("update/w_1", "linear")
    return m


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX EVONet params tree (array leaves) -> the port's EVONet state
    dict, with the scorer where the tree has one (the "gradient" and
    "random" selectors' trees have none) and any number of input channels
    (5 voxel bins, 3 for frames). Raises on a missing weight and on any
    unused leaf."""
    leaves = _flatten(params)
    scorer = any(k.startswith("patchify/scorer/") for k in leaves)
    used = set()
    sd = {}
    for tkey, (fpath, kind) in build_mapping(scorer).items():
        if kind == "norm":
            names = {"scale": "weight", "bias": "bias"}
        else:
            names = {"kernel": "weight", "bias": "bias"}
        if f"{fpath}/{next(iter(names))}" not in leaves:
            if "downsample" in tkey:
                continue
            raise ValueError(f"params tree is missing {fpath}")
        for leaf, tname in names.items():
            a = leaves[f"{fpath}/{leaf}"]
            used.add(f"{fpath}/{leaf}")
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if kind == "conv" else a.T
            sd[f"{tkey}.{tname}"] = torch.from_numpy(np.array(a, copy=True))
    unused = sorted(set(leaves) - used)
    if unused:
        raise ValueError(f"unused params leaves: {unused[:10]}")
    return sd


def load_weights(weights) -> Dict[str, torch.Tensor]:
    """A state dict, or the path of a DEVO checkpoint, as an EVONet state
    dict, with the reference loader's legacy handling (devo.py:111-120):
    'module.' prefixes stripped, 'update.lmbda' dropped."""
    if not isinstance(weights, Mapping):
        weights = torch.load(weights, map_location="cpu", weights_only=False)
        weights = weights.get("model_state_dict", weights)
    return {k.replace("module.", ""): v for k, v in weights.items()
            if "update.lmbda" not in k}


def random_state_dict(net: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights for `net`, drawn as the JAX package's flax
    initializers draw them: normal(0, 1/fan_in) kernels, zero biases, unit
    LayerNorm scales."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in net.state_dict().items():
        if name.endswith("bias"):
            sd[name] = torch.zeros_like(p)
        elif p.ndim == 1:
            sd[name] = torch.ones_like(p)
        else:
            fan_in = p[0].numel()
            sd[name] = torch.randn(p.shape, generator=g) / fan_in ** 0.5
    return sd
