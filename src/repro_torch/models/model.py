"""Model assembly: embed → blocks → norm → head, and the serving entry points.

Counterpart of the reference's ``models/model.py`` for the families the
port serves: ``dense``, ``ssm`` (Mamba2) and ``hybrid`` (Zamba2: Mamba2
blocks with one weight-shared dense block after every
``shared_attn_every``-th of them).  ``moe``, ``vlm`` and ``audio`` raise
:class:`NotImplementedError` (ROADMAP A11).

The reference stacks each parameter over a scanned layer axis (hybrids over
``(L/every, every)``) and runs ``lax.scan``; here a :class:`Model` holds one
module per layer in an ``nn.ModuleList`` and a Python loop walks them.  The
reference's ``_maybe_remat`` and ``logical_constraint`` do nothing when
serving on one card and are dropped; they return with training and
sharding.  ``forward_train`` waits for the training slice.

Entry points, with the reference's names:

* :func:`init_params` — a randomly initialised :class:`Model` on the card
  (``device=None``) or where asked;
* :func:`load_jax_params` — the reference's parameter tree, as numpy
  arrays, as a :class:`Model`;
* :func:`cache_shapes` / :func:`init_cache` — the serving cache, a dict
  with the reference's keys, shapes and dtypes;
* :func:`prefill` / :func:`decode_step` — run where the model's parameters
  are.  ``decode_step`` updates the cache's tensors in place and returns
  the same dict.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import update_positions
from repro_torch.models.blocks import CONV_KW, DenseBlock, Mamba2Block
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_lookup, rmsnorm
from repro_torch.models.params import ParamDef, init_param

__all__ = ["Model", "init_params", "load_jax_params", "cache_shapes",
           "init_cache", "prefill", "decode_step"]

_WAITING = {
    "moe": "the MoE family waits for ROADMAP A11 (MoE, VLM and audio)",
    "vlm": "the VLM family (M-RoPE) waits for ROADMAP A11 (MoE, VLM and "
           "audio)",
    "audio": "the audio family (encoder-only) waits for ROADMAP A11 (MoE, "
             "VLM and audio)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _WAITING:
        raise NotImplementedError(f"{cfg.name}: {_WAITING[cfg.family]}")
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"shared_attn_every {cfg.shared_attn_every}")


def _n_scan(cfg: ModelConfig) -> int:
    """The reference's scan length (super-layers for a hybrid)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Model(nn.Module):
    """embed, one block per layer, (hybrid) the shared block, final_ln,
    head; parameter names follow the reference's tree (``blocks.3.mamba.
    in_proj`` ↔ ``params["blocks"]["mamba"]["in_proj"][3]``)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator], device):
        _check_family(cfg)
        super().__init__()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(init_param(ParamDef((V, D)), generator,
                                             device))
        block = DenseBlock if cfg.family == "dense" else Mamba2Block
        self.blocks = nn.ModuleList(block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = DenseBlock(cfg, generator, device)
        self.final_ln = nn.Parameter(init_param(
            ParamDef((D,), init="ones"), generator, device))
        self.head = nn.Parameter(init_param(ParamDef((D, V)), generator,
                                            device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """A :class:`Model` with weights drawn from ``generator`` (on the
    generator's device, then moved to ``device``; None means the card)."""
    return Model(cfg, generator, resolve_device(device))


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def load_jax_params(cfg: ModelConfig, tree: Dict, device=None) -> Model:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as a :class:`Model`.

    Unstacks the scan axis (and a hybrid's ``(L/every, every)`` double
    stack) into one block per layer and places the shared block.  Raises if
    a shape differs or a leaf of the tree has no counterpart.
    """
    model = Model(cfg, None, resolve_device(device))
    every = cfg.shared_attn_every
    seen = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            parts = tuple(name.split("."))
            if parts[0] == "blocks":
                i, path = int(parts[1]), ("blocks",) + parts[2:]
                idx = (i // every, i % every) if cfg.family == "hybrid" \
                    else (i,)
            else:
                path, idx = parts, ()
            node = tree
            for key in path:
                node = node[key]
            arr = np.array(np.asarray(node)[idx], dtype=np.float32)
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{name}: reference {arr.shape} vs port "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))
            seen.add(path)
    missing = set(_leaf_paths(tree)) - seen
    if missing:
        raise ValueError(f"reference leaves with no counterpart: "
                         f"{sorted(missing)}")
    return model


# ---------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int) -> Dict:
    """``{name: (shape, dtype)}`` of the serving cache, as the reference's
    ``cache_shapes``: k/v per attention application, one ``kv_positions``
    shared by all of them, float32 SSM states and compute-dtype conv tails
    per Mamba2 block."""
    _check_family(cfg)
    dt = _dtype(cfg.dtype)
    L = _n_scan(cfg)
    out: Dict = {}
    K, hd = cfg.n_kv_heads, cfg.hd
    if cfg.family == "dense":
        out["k"] = ((L, batch, capacity, K, hd), dt)
        out["v"] = ((L, batch, capacity, K, hd), dt)
        out["kv_positions"] = ((batch, capacity), torch.int32)
    else:
        H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * N
        nl = (L, cfg.shared_attn_every) if cfg.family == "hybrid" else (L,)
        out["ssm"] = (nl + (batch, H, P, N), torch.float32)
        out["conv"] = (nl + (batch, CONV_KW - 1, conv_dim), dt)
    if cfg.family == "hybrid":
        cap = capacity if cfg.sliding_window is None else min(
            capacity, cfg.sliding_window)
        out["k"] = ((L, batch, cap, K, hd), dt)
        out["v"] = ((L, batch, cap, K, hd), dt)
        out["kv_positions"] = ((batch, cap), torch.int32)
    return out


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Dict:
    """An empty serving cache: zeros, and -1 for every KV position."""
    dev = resolve_device(device)
    out = {k: torch.zeros(shape, dtype=dt, device=dev)
           for k, (shape, dt) in cache_shapes(cfg, batch, capacity).items()}
    if "kv_positions" in out:
        out["kv_positions"].fill_(-1)
    return out


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _embed_inputs(model: Model, cfg: ModelConfig, batch: Dict):
    return embed_lookup(model.embed, batch["tokens"], _dtype(cfg.dtype))


def _default_positions(Bsz: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(Bsz, S)


def _forward_seq(model: Model, cfg: ModelConfig, h, positions,
                 collect_cache: bool):
    """Prefill body.  Returns ``(h, cache_ys)``: per layer (and attention
    application) the k/v, final SSM states and conv tails when
    ``collect_cache``, else None."""
    window = cfg.sliding_window
    kvs, ssms, convs = [], [], []
    for i, blk in enumerate(model.blocks):
        if cfg.family == "dense":
            h, kv = blk(h, positions, window=window, return_kv=collect_cache)
            kvs.append(kv)
            continue
        h, ssm, conv = blk(h)
        ssms.append(ssm)
        convs.append(conv)
        if cfg.family == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
            h, kv = model.shared(h, positions, window=window,
                                 return_kv=collect_cache)
            kvs.append(kv)
    if not collect_cache:
        return h, None
    ys = {"kv": kvs} if kvs else {}
    if ssms:
        ys.update(ssm=ssms, conv=convs)
    return h, ys


def _head_logits(model: Model, cfg: ModelConfig, h) -> torch.Tensor:
    """float32 logits of compute-dtype activations and head, as the
    reference's ``preferred_element_type=float32``."""
    h = rmsnorm(h, model.final_ln, cfg.norm_eps)
    return h.float() @ model.head.to(h.dtype).float()


@torch.no_grad()
def prefill(model: Model, cfg: ModelConfig, batch: Dict,
            capacity: Optional[int] = None):
    """Full-sequence forward; returns ``(last-token logits (B,1,V) f32,
    serving cache)``.  batch: ``tokens`` (B,S) and optional ``positions``."""
    _check_family(cfg)
    h = _embed_inputs(model, cfg, batch)
    Bsz, S = h.shape[0], h.shape[1]
    capacity = capacity or S
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(Bsz, S, h.device)
    h, ys = _forward_seq(model, cfg, h, positions, collect_cache=True)
    logits = _head_logits(model, cfg, h[:, -1:, :])

    cache: Dict = {}
    ring = cfg.family == "hybrid" and cfg.sliding_window is not None
    if "kv" in ys:
        k = torch.stack([kv[0] for kv in ys["kv"]])  # (L, B, S, K, hd)
        v = torch.stack([kv[1] for kv in ys["kv"]])
        cap = capacity
        if ring:
            cap = min(capacity, cfg.sliding_window)
            k, v = k[:, :, -cap:], v[:, :, -cap:]
        pad = cap - k.shape[2]
        if pad > 0:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
        cache["k"], cache["v"] = k.contiguous(), v.contiguous()
        kv_pos = _default_positions(Bsz, k.shape[2], h.device)
        if ring:
            kv_pos = kv_pos + max(S - cap, 0)
        cache["kv_positions"] = torch.where(kv_pos < S, kv_pos, -1).to(
            torch.int32)
    if "ssm" in ys:
        ssm = torch.stack(ys["ssm"]).float()
        conv = torch.stack(ys["conv"])
        if cfg.family == "hybrid":
            nl = (_n_scan(cfg), cfg.shared_attn_every)
            ssm = ssm.reshape(nl + ssm.shape[1:])
            conv = conv.reshape(nl + conv.shape[1:])
        cache["ssm"], cache["conv"] = ssm, conv
    return logits, cache


@torch.no_grad()
def decode_step(model: Model, cfg: ModelConfig, batch: Dict, cache: Dict,
                pos: torch.Tensor):
    """One-token decode.  batch: ``tokens`` (B,); pos: (B,) int.

    Returns ``(logits (B,1,V) f32, cache)``; the cache's tensors are
    updated in place.
    """
    _check_family(cfg)
    h = embed_lookup(model.embed, batch["tokens"][:, None], _dtype(cfg.dtype))
    kv_positions = cache.get("kv_positions")
    if kv_positions is not None:
        update_positions(kv_positions, pos)
    window = cfg.sliding_window
    every = cfg.shared_attn_every
    for i, blk in enumerate(model.blocks):
        if cfg.family == "dense":
            h = blk.decode(h, pos, cache["k"][i], cache["v"][i],
                           kv_positions, window=window)
            continue
        idx = (i // every, i % every) if cfg.family == "hybrid" else (i,)
        h, conv, ssm = blk.decode(h, cache["conv"][idx], cache["ssm"][idx])
        cache["conv"][idx] = conv
        cache["ssm"][idx] = ssm
        if cfg.family == "hybrid" and (i + 1) % every == 0:
            j = i // every
            h = model.shared.decode(h, pos, cache["k"][j], cache["v"][j],
                                    kv_positions, window=window)
    return _head_logits(model, cfg, h), cache
