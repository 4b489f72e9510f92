"""Seeded random weights of EVONet, made on the device in one draw.

The names and shapes come from the reference's module tree, which is a
frozen copy of the port's (the port's state dict has the same keys). As
the port's own random weights are drawn: normal(0, 1/fan_in) kernels,
zero biases, unit 1-D scales.
"""
from __future__ import annotations

from typing import Dict

import torch


def shapes(dim_inet: int, dim_fnet: int, dim: int, bins: int, patch: int = 3,
           selector: str = "scorer") -> Dict[str, torch.Size]:
    from benchmark.reference.nets.evonet import EVONet
    with torch.device("meta"):
        net = EVONet(patch, dim_inet, dim_fnet, dim, bins, selector)
    return {k: v.shape for k, v in net.state_dict().items()}


def random_weights(spec: Dict[str, torch.Size], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """One f32 draw of every kernel from a generator on `device` seeded
    with `seed`, split into the leaves."""
    device = torch.device(device)
    kernels = [k for k, s in spec.items()
               if not k.endswith("bias") and len(s) > 1]
    total = sum(spec[k].numel() for k in kernels)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, s in spec.items():
        if k in kernels:
            n = s.numel()
            fan_in = n // s[0]
            out[k] = (flat[at:at + n] / fan_in ** 0.5).reshape(s)
            at += n
        elif k.endswith("bias"):
            out[k] = torch.zeros(s, device=device)
        else:
            out[k] = torch.ones(s, device=device)
    return out
