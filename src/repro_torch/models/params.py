"""Parameter declarations and their initialisation.

Each parameter is declared once as a :class:`ParamDef` (shape, logical
sharding axes and init kind), as in the reference's ``models/params.py``;
a :class:`ParamModule` turns a dict of them into ``nn.Parameter``s drawn
from an explicit ``torch.Generator``.  The axes are the reference's
(``launch.partitioning`` maps them to mesh axes); its stacked scan axis
("layer", never sharded) is not declared, since the port holds one module
per layer, and ``models.tree_specs`` adds it back.  Masters are float32 (the
configs' ``param_dtype``).  The generator gives other numbers than
``jax.random`` from the same seed: carry the reference's weights with
:func:`repro_torch.models.load_jax_params` to compare the two.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

__all__ = ["Axes", "ParamDef", "ParamModule", "init_param"]

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Axes                # logical sharding axis of each dimension
    init: str = "normal"      # normal | zeros | ones
    init_scale: float = 0.02
    # draws the value from a generator on the device it should be made on
    custom_init: Optional[Callable[[torch.Generator], torch.Tensor]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def init_param(d: ParamDef, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """The initial float32 value of ``d`` on ``device``.

    Draws on the generator's device and moves the result.  Without a
    generator the tensor is left uninitialised, for weights that are about
    to be loaded.
    """
    if generator is None:
        return torch.empty(d.shape, dtype=torch.float32, device=device)
    if d.custom_init is not None:
        t = d.custom_init(generator)
    elif d.init == "zeros":
        t = torch.zeros(d.shape, dtype=torch.float32)
    elif d.init == "ones":
        t = torch.ones(d.shape, dtype=torch.float32)
    else:
        t = torch.randn(d.shape, generator=generator,
                        device=generator.device) * d.init_scale
    return t.to(device=device, dtype=torch.float32)


class ParamModule(nn.Module):
    """A module whose parameters are declared by ``{name: ParamDef}``."""

    def __init__(self, defs: Dict[str, ParamDef],
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        for name, d in defs.items():
            self.register_parameter(
                name, nn.Parameter(init_param(d, generator, device)))
