"""The program under test, as the benchmark builds it: the port's
configuration object from a ``configs/*.json`` file, and the port's
:class:`Model` holding the benchmark's weights under their names."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


def model_config(spec: dict):
    """The port's config for ``spec["arch"]`` with every number of the
    file's ``model`` put in, so that the file is the configuration run."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(spec["arch"]), **spec["model"])


def build_model(cfg, weights: dict):
    """A port :class:`Model` whose parameters are ``weights`` (no copy);
    raises if a name is missing on either side or a shape differs."""
    from repro_torch.models.model import Model
    model = Model(cfg, None, torch.device("meta"))
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise ValueError(f"parameter names differ: program only "
                         f"{sorted(names - set(weights))[:5]}, benchmark "
                         f"only {sorted(set(weights) - names)[:5]}")
    for name, p in list(model.named_parameters()):
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                             f"{tuple(weights[name].shape)}")
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, attr, nn.Parameter(weights[name]))
    return model
