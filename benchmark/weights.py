"""Weights made by the benchmark from the run's seed, on the device, in a few
large calls, and handed alike to the program and to the plain reference.

A weight list is ``[(name, shape, kind, std)]`` with kind ``normal``
(N(0, std)), ``scale`` (N(1, std)), ``trunc`` (N(0, std) truncated at two
standard deviations, by the inverse normal CDF of a uniform draw) or
``zero``.  ``draw`` makes every tensor of the list from one normal and one
uniform draw of a generator on the device seeded with ``seed``; the same
list and seed give the same tensors.
"""

from __future__ import annotations

import math

import torch

# the standard deviation of N(0, 1) truncated at +-2
TRUNC_STD = 0.87962566103423978


def draw(specs, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    counts = {"normal": 0, "trunc": 0}
    for _, shape, kind, _ in specs:
        if kind in ("normal", "scale"):
            counts["normal"] += math.prod(shape)
        elif kind == "trunc":
            counts["trunc"] += math.prod(shape)
    normal = torch.randn(counts["normal"], generator=gen, device=device)
    edge = math.erf(2.0 / math.sqrt(2.0))
    trunc = torch.rand(counts["trunc"], generator=gen, device=device)
    trunc = torch.erfinv(trunc * (2 * edge) - edge) * math.sqrt(2.0)
    out, at = {}, {"normal": 0, "trunc": 0}
    for name, shape, kind, std in specs:
        n = math.prod(shape)
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        pool = "trunc" if kind == "trunc" else "normal"
        z = (trunc if pool == "trunc" else normal)[at[pool]:at[pool] + n]
        at[pool] += n
        scale = std / TRUNC_STD if kind == "trunc" else std
        out[name] = (z * scale + (1.0 if kind == "scale" else 0.0)
                     ).view(shape)
    return out


def load_into(net: torch.nn.Module, weights: dict, prefix: str) -> None:
    """Copy ``weights[prefix + name]`` into each parameter of ``net``."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(weights[prefix + name])
