"""Seeded float32 weights, made on the device in a few large calls.

A network's tensors are listed by its reference ``spec`` as (name, shape,
init). Kernels are truncated normal at ±2 standard deviations (flax's
``variance_scaling``: ``he`` has variance 2 / fan_in, ``lecun`` 1 /
fan_in), drawn for all kernels at once by the inverse CDF of one uniform
draw; biases and BatchNorm shifts are 0, BatchNorm scales and variances 1,
and the last BatchNorm scale of each residual branch is uniform in [0.05,
0.15], so that the residual branches compute (a zero scale would leave them
out of the result) while the activations of a deep random network stay
finite. Both the program and the reference get these tensors.

``shaping`` (a configuration file's ``seeded_weights``) tempers the
network as a trained one behaves: ``rpn_delta_scale`` scales the RPN's
box-delta kernels, so that proposals stay near their anchors (the
``--realistic`` recipe of the program's bench). The class outputs are
shaped afterwards (:mod:`perfbench.shaping`).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def _fan_in(init: str, shape: Tuple[int, ...]) -> int:
    out_dim = 1 if init == "lecun_transposed" else 0
    return math.prod(shape) // shape[out_dim]


def make(spec: Iterable[Tuple[str, Tuple[int, ...], str]], seed: int, device,
         shaping: dict) -> Dict[str, torch.Tensor]:
    """The tensors of ``spec`` from ``seed`` on ``device`` (float32)."""
    spec = list(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    kernels = [(n, s, i) for n, s, i in spec if i in ("he",) or i.startswith("lecun")]
    stds = []
    for _, shape, init in kernels:
        gain = 2.0 if init == "he" else 1.0
        std = math.sqrt(gain / _fan_in(init, shape)) / _TRUNC_STD
        if init == "lecun_rpn_deltas":
            std *= shaping.get("rpn_delta_scale", 1.0)
        stds.append(std)
    sizes = [math.prod(s) for _, s, _ in kernels]
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float64)
    z = torch.erfinv(2.0 * (_PHI_LO + u * (_PHI_HI - _PHI_LO)) - 1.0) * math.sqrt(2.0)
    z = (z * torch.repeat_interleave(torch.tensor(stds, dtype=torch.float64, device=device),
                                     torch.tensor(sizes, device=device))).to(torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, _), part in zip(kernels, torch.split(z, sizes)):
        out[name] = part.view(shape)
    residual = [(n, s) for n, s, i in spec if i == "residual_scale"]
    if residual:
        r = torch.rand(sum(s[0] for _, s in residual), generator=gen, device=device)
        for (name, shape), part in zip(residual, torch.split(0.05 + 0.1 * r,
                                                             [s[0] for _, s in residual])):
            out[name] = part.view(shape)
    for name, shape, init in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif name not in out:
            raise ValueError(f"{name}: unknown init {init!r}")
    return {name: out[name] for name, _, _ in spec}
