"""Seeded weights, made on the device in a few large calls.

The benchmark makes the weights and hands the same ones to the program (by
parameter name) and to the reference.  All normal draws come from one
``torch.randn`` into one float32 buffer, grouped by scale so that each
group is scaled by one multiply; the other inits fill their own buffer.
The masters are float32, the type the configurations state.  The same seed
gives the same weights, so the reference remakes them after the program
has run rather than taking anything the program held.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one of the run's streams of draws
    (weights 0, traffic 1, ...), seeded from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def make(defs: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``defs`` (``{name: (shape, init,
    scale)}``), views into two flat buffers."""
    g = generator(seed, device, 0)
    normal = sorted((n for n, d in defs.items() if d[1] == "normal"),
                    key=lambda n: (defs[n][2], n))
    other = sorted(n for n, d in defs.items() if d[1] != "normal")
    size = lambda n: math.prod(defs[n][0])  # noqa: E731
    flat = torch.randn(sum(size(n) for n in normal), generator=g,
                       device=device)
    out, off = {}, 0
    for scale in sorted({defs[n][2] for n in normal}):
        start = off
        for n in normal:
            if defs[n][2] == scale:
                out[n] = flat[off:off + size(n)].view(defs[n][0])
                off += size(n)
        flat[start:off].mul_(scale)
    rest = torch.empty(sum(size(n) for n in other), device=device)
    off = 0
    for n in other:
        shape, init, _ = defs[n]
        t = rest[off:off + size(n)].view(shape)
        off += size(n)
        if init == "ones":
            t.fill_(1.0)
        else:
            raise ValueError(f"{n}: unknown init {init!r}")
        out[n] = t
    return out
