"""Model assembly: embed → blocks → norm → head; serving and training.

Counterpart of the reference's ``models/model.py`` for all six families:
``dense``, ``moe`` (attention + top-k experts, ``models/moe.py``), ``vlm``
(dense blocks under M-RoPE, fed ``embeds`` and 3-axis ``positions`` by a
stubbed vision frontend), ``audio`` (encoder-only dense blocks with
non-causal attention, fed ``embeds``; no cache, no decode: see
``runtime.make_encode_step``), ``ssm`` (Mamba2) and ``hybrid`` (Zamba2:
Mamba2 blocks with one weight-shared dense block after every
``shared_attn_every``-th of them).

The reference stacks each parameter over a scanned layer axis (hybrids over
``(L/every, every)``) and runs ``lax.scan``; here a :class:`Model` holds one
module per layer in an ``nn.ModuleList`` and a Python loop walks them, one
scan step at a time (a block, or a hybrid's super-layer of ``every`` Mamba2
blocks and the shared block).  The reference's ``_maybe_remat`` becomes
``torch.utils.checkpoint`` around that same step when ``cfg.remat ==
"full"`` and autograd records; ``logical_constraint`` (sharding) has no
counterpart on one card.

Entry points, with the reference's names:

* :func:`init_params` — a randomly initialised :class:`Model` on the card
  (``device=None``) or where asked;
* :func:`load_jax_params` — the reference's parameter tree, as numpy
  arrays, as a :class:`Model`;
* :func:`cache_shapes` / :func:`init_cache` — the serving cache, a dict
  with the reference's keys, shapes and dtypes;
* :func:`prefill` / :func:`decode_step` — run where the model's parameters
  are.  ``decode_step`` updates the cache's tensors in place and returns
  the same dict;
* :func:`forward_train` — ``(loss, metrics)`` of a batch of tokens (or
  embeds) and labels through the reference's fused LM head and cross
  entropy, with autograd recording (on the card the forward and backward
  kernels of attention and SSD); an MoE model adds ``0.01 ·
  moe_aux_loss``, its aux terms averaged over the layers;
* :func:`export_tree` / :func:`import_tree` — named tensors (parameters,
  AdamW moments) to and from the reference's stacked tree of numpy arrays,
  the layout of its checkpoints.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import update_positions
from repro_torch.models.blocks import (CONV_KW, DenseBlock, Mamba2Block,
                                      MoEBlock)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_lookup, rmsnorm
from repro_torch.models.params import ParamDef, init_param

__all__ = ["Model", "init_params", "load_jax_params", "decayed",
           "export_tree", "import_tree", "tree_shapes", "cache_shapes",
           "init_cache", "prefill", "decode_step", "forward_train"]

_ATTN = ("dense", "vlm", "audio")   # stacks of dense blocks
_KV = ("dense", "moe", "vlm")       # one k/v cache entry per layer


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _ATTN + ("moe", "ssm", "hybrid"):
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
        block = (DenseBlock if cfg.family in _ATTN else
                 MoEBlock if cfg.family == "moe" else Mamba2Block)
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


def _ref_path(cfg: ModelConfig, name: str):
    """``(path, index)`` of the port's parameter ``name`` in the reference's
    tree: ``blocks.3.mamba.in_proj`` → ``(("blocks", "mamba", "in_proj"),
    (3,))``, or ``((0, 3),)`` for a hybrid's ``(L/every, every)`` stack."""
    parts = tuple(name.split("."))
    if parts[0] != "blocks":
        return parts, ()
    i, every = int(parts[1]), cfg.shared_attn_every
    idx = (i // every, i % every) if cfg.family == "hybrid" else (i,)
    return ("blocks",) + parts[2:], idx


def _stack_shape(cfg: ModelConfig) -> tuple:
    if cfg.family == "hybrid":
        return (_n_scan(cfg), cfg.shared_attn_every)
    return (cfg.n_layers,)


def _put(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def decayed(cfg: ModelConfig, named: Dict[str, torch.Tensor]) -> Dict:
    """``{name: bool}``: the tensors the reference's AdamW decays, those
    with ``ndim > 1`` in its stacked layout (every block parameter, and the
    matrices outside the blocks)."""
    out = {}
    for name, t in named.items():
        stacked = _stack_shape(cfg) if _ref_path(cfg, name)[1] else ()
        out[name] = len(stacked) + t.dim() > 1
    return out


def tree_shapes(cfg: ModelConfig, named: Dict[str, torch.Tensor]) -> Dict:
    """The reference-layout tree of the shapes of ``named`` (``{port
    parameter name: tensor}``): blocks stacked over the scan axis."""
    out: Dict = {}
    for name, t in named.items():
        path, idx = _ref_path(cfg, name)
        shape = (_stack_shape(cfg) if idx else ()) + tuple(t.shape)
        _put(out, path, shape)
    return out


def export_tree(cfg: ModelConfig, named: Dict[str, torch.Tensor]) -> Dict:
    """``named`` (``{port parameter name: tensor}``, e.g. the parameters or
    an AdamW moment) as the reference's tree of numpy arrays, blocks
    stacked over the scan axis: the inverse of :func:`import_tree`.  The
    arrays are copies on the host."""
    out: Dict = {}
    stacks: Dict = {}
    for name, t in named.items():
        path, idx = _ref_path(cfg, name)
        arr = t.detach().cpu().numpy()
        if not idx:
            _put(out, path, arr.copy())
            continue
        if path not in stacks:
            stacks[path] = np.empty(_stack_shape(cfg) + arr.shape, arr.dtype)
            _put(out, path, stacks[path])
        stacks[path][idx] = arr
    return out


def import_tree(cfg: ModelConfig, tree: Dict,
                named: Dict[str, torch.Tensor]) -> None:
    """Copy the reference-layout ``tree`` (nested dicts of numpy arrays)
    into the tensors of ``named`` in place, unstacking the scan axis (and a
    hybrid's ``(L/every, every)`` double stack).  Raises if a shape differs
    or a leaf of the tree has no counterpart."""
    seen = set()
    with torch.no_grad():
        for name, t in named.items():
            path, idx = _ref_path(cfg, name)
            node = tree
            for key in path:
                node = node[key]
            arr = np.array(np.asarray(node)[idx], dtype=np.float32)
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{name}: reference {arr.shape} vs port "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
            seen.add(path)
    missing = set(_leaf_paths(tree)) - seen
    if missing:
        raise ValueError(f"reference leaves with no counterpart: "
                         f"{sorted(missing)}")


def load_jax_params(cfg: ModelConfig, tree: Dict, device=None) -> Model:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as a :class:`Model`, through
    :func:`import_tree`."""
    model = Model(cfg, None, resolve_device(device))
    import_tree(cfg, tree, dict(model.named_parameters()))
    return model


# ---------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int) -> Dict:
    """``{name: (shape, dtype)}`` of the serving cache, as the reference's
    ``cache_shapes``: k/v per attention application, one ``kv_positions``
    shared by all of them, float32 SSM states and compute-dtype conv tails
    per Mamba2 block; empty for an encoder-only (audio) model."""
    _check_family(cfg)
    dt = _dtype(cfg.dtype)
    L = _n_scan(cfg)
    out: Dict = {}
    K, hd = cfg.n_kv_heads, cfg.hd
    if cfg.family in _KV:
        out["k"] = ((L, batch, capacity, K, hd), dt)
        out["v"] = ((L, batch, capacity, K, hd), dt)
        out["kv_positions"] = ((batch, capacity), torch.int32)
    elif cfg.family in ("ssm", "hybrid"):
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
    if "embeds" in batch:  # a stubbed modality frontend (vlm / audio)
        return batch["embeds"].to(_dtype(cfg.dtype))
    return embed_lookup(model.embed, batch["tokens"], _dtype(cfg.dtype))


def _positions(Bsz: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(Bsz, S)


def _default_positions(cfg: ModelConfig, Bsz: int, S: int,
                       device) -> torch.Tensor:
    """``(B, S)`` token positions, or ``(B, S, 3)`` under M-RoPE (the same
    id on all three axes)."""
    pos = _positions(Bsz, S, device)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(Bsz, S, 3)
    return pos


def _scan_steps(model: Model, cfg: ModelConfig):
    """The reference's scan steps as ``(blocks, shared block or None)``: one
    block each for the other families, a super-layer of ``every`` Mamba2 blocks
    and the shared block for a hybrid (``model.py:233``)."""
    if cfg.family != "hybrid":
        return [([blk], None) for blk in model.blocks]
    e = cfg.shared_attn_every
    return [(list(model.blocks[j * e:(j + 1) * e]), model.shared)
            for j in range(_n_scan(cfg))]


def _scan_step(cfg: ModelConfig, blocks, shared, h, positions,
               collect_cache: bool):
    """One scan step.  Returns ``(h, kvs, ssms, convs, aux)``, ``aux`` the
    MoE block's aux dict (empty for the other families)."""
    window = cfg.sliding_window
    kvs, ssms, convs, aux = [], [], [], {}
    for blk in blocks:
        if cfg.family in _ATTN:
            h, kv = blk(h, positions, window=window, return_kv=collect_cache)
            kvs.append(kv)
        elif cfg.family == "moe":
            h, kv, aux = blk(h, positions, window=window,
                             return_kv=collect_cache)
            kvs.append(kv)
        else:
            h, ssm, conv = blk(h)
            ssms.append(ssm)
            convs.append(conv)
    if shared is not None:
        h, kv = shared(h, positions, window=window, return_kv=collect_cache)
        kvs.append(kv)
    return h, kvs, ssms, convs, aux


def _forward_seq(model: Model, cfg: ModelConfig, h, positions,
                 collect_cache: bool, remat: bool = False):
    """Shared train/prefill body.  Returns ``(h, cache_ys, aux)``:
    ``cache_ys`` per layer (and attention application) the k/v, final SSM
    states and conv tails when ``collect_cache``, else None; ``aux`` each
    MoE aux term averaged over the layers (empty for the other families).
    With ``remat`` (training only) each scan step keeps only its input for
    the backward and runs again there; the aux terms come out of the
    checkpoint with ``h``."""
    def step_h_aux(x, blocks, shared):
        out = _scan_step(cfg, blocks, shared, x, positions, False)
        return out[0], out[-1]

    kvs, ssms, convs, auxs = [], [], [], []
    for blocks, shared in _scan_steps(model, cfg):
        if remat:
            h, aux = checkpoint(step_h_aux, h, blocks, shared,
                                use_reentrant=False)
            auxs.append(aux)
            continue
        h, kv, ssm, conv, aux = _scan_step(cfg, blocks, shared, h,
                                           positions, collect_cache)
        kvs += kv
        ssms += ssm
        convs += conv
        auxs.append(aux)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    if not collect_cache:
        return h, None, aux
    ys = {"kv": kvs} if kvs else {}
    if ssms:
        ys.update(ssm=ssms, conv=convs)
    return h, ys, aux


def _head_logits(model: Model, cfg: ModelConfig, h) -> torch.Tensor:
    """float32 logits of compute-dtype activations and head, as the
    reference's ``preferred_element_type=float32``."""
    h = rmsnorm(h, model.final_ln, cfg.norm_eps)
    return h.float() @ model.head.to(h.dtype).float()


def _fused_head_ce(model: Model, cfg: ModelConfig, h: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """The reference's fused LM head + cross entropy, with its roundings:
    the logits are rounded to the compute dtype before the max and the
    exponent, and the gold logit is ``h · head[:, label]`` in float32 (a
    gather of head columns, not of the logits)."""
    h = rmsnorm(h, model.final_ln, cfg.norm_eps)
    head = model.head.to(h.dtype)
    # in bf16 one rounding of the float32 accumulation, as the reference's
    # einsum(preferred_element_type=float32).astype(h.dtype)
    logits = h @ head
    m = torch.amax(logits, dim=-1)
    ex = torch.exp((logits - m[..., None]).float())
    lse = m.float() + torch.log(torch.sum(ex, dim=-1))
    Bsz, S = labels.shape
    # advanced indexing: its backward accumulates deterministically on CUDA
    gold_cols = head[:, labels.reshape(-1).long()]             # (D, B*S)
    gold_cols = gold_cols.T.reshape(Bsz, S, head.shape[0])
    gold = torch.sum(h.float() * gold_cols.float(), dim=-1)
    return torch.mean(lse - gold)


def forward_train(model: Model, cfg: ModelConfig, batch: Dict):
    """Returns ``(loss, metrics)`` with autograd recording.  batch:
    ``tokens`` (B,S) int or ``embeds`` (B,S,D), ``labels`` (B,S) int and
    optional ``positions`` ((B,S,3) under M-RoPE).  metrics: ``ce_loss``,
    for an MoE model the three aux terms averaged over the layers, and
    ``loss`` (``ce_loss + 0.01 · moe_aux_loss`` for an MoE model).

    With ``cfg.logits_chunk`` and ``S > logits_chunk`` the head and cross
    entropy run over ``S // logits_chunk`` chunks, as the reference (a
    ragged tail past the last full chunk is left out, as there).
    """
    _check_family(cfg)
    h = _embed_inputs(model, cfg, batch)
    Bsz, S = h.shape[0], h.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, Bsz, S, h.device)
    h, _, aux = _forward_seq(model, cfg, h, positions, collect_cache=False,
                             remat=cfg.remat == "full"
                             and torch.is_grad_enabled())
    labels = batch["labels"]
    if cfg.logits_chunk and S > cfg.logits_chunk:
        n, c = S // cfg.logits_chunk, cfg.logits_chunk
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            total = total + _fused_head_ce(model, cfg, h[:, sl],
                                           labels[:, sl])
        loss = total / n
    else:
        loss = _fused_head_ce(model, cfg, h, labels)
    metrics = dict(ce_loss=loss, **aux)
    if "moe_aux_loss" in aux:
        loss = loss + 0.01 * aux["moe_aux_loss"]
    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def prefill(model: Model, cfg: ModelConfig, batch: Dict,
            capacity: Optional[int] = None):
    """Full-sequence forward; returns ``(last-token logits (B,1,V) f32,
    serving cache)``.  batch: ``tokens`` (B,S) or ``embeds`` (B,S,D), and
    optional ``positions``.  Raises ``ValueError`` for an encoder-only
    model."""
    _check_family(cfg)
    if cfg.is_encoder_only:
        raise ValueError("encoder-only models have no decode/prefill cache")
    h = _embed_inputs(model, cfg, batch)
    Bsz, S = h.shape[0], h.shape[1]
    capacity = capacity or S
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, Bsz, S, h.device)
    h, ys, _ = _forward_seq(model, cfg, h, positions, collect_cache=True)
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
        kv_pos = _positions(Bsz, k.shape[2], h.device)
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
    """One-token decode.  batch: ``tokens`` (B,) or ``embeds`` (B,1,D);
    pos: (B,) int (on all three M-RoPE axes).

    Returns ``(logits (B,1,V) f32, cache)``; the cache's tensors are
    updated in place.  Raises ``ValueError`` for an encoder-only model.
    """
    _check_family(cfg)
    if cfg.is_encoder_only:
        raise ValueError("encoder-only models have no decode step")
    if "embeds" in batch:
        h = batch["embeds"].to(_dtype(cfg.dtype))
    else:
        h = embed_lookup(model.embed, batch["tokens"][:, None],
                         _dtype(cfg.dtype))
    kv_positions = cache.get("kv_positions")
    if kv_positions is not None:
        update_positions(kv_positions, pos)
    window = cfg.sliding_window
    every = cfg.shared_attn_every
    for i, blk in enumerate(model.blocks):
        if cfg.family in _KV:
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
