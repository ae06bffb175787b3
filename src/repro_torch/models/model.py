"""Model assembly: embed → blocks → norm → head; serving and training.

Counterpart of the reference's ``models/model.py`` for all six families:
``dense``, ``moe`` (attention + top-k experts, ``models/moe.py``), ``vlm``
(dense blocks under M-RoPE, fed ``embeds`` and 3-axis ``positions`` by a
stubbed vision frontend), ``audio`` (encoder-only dense blocks with
non-causal attention, fed ``embeds``; no cache, no decode: see
``runtime.make_encode_step``), ``ssm`` (Mamba2) and ``hybrid`` (Zamba2:
Mamba2 blocks with one weight-shared dense block after every
``shared_attn_every``-th of them, the reference's form; or Zamba2's own,
a :class:`Zamba2Config`: before each Mamba2 layer that
``hybrid_layer_ids`` names, use ``u`` of shared block ``u % num_mem_blocks`` reads the stream and the
embeddings side by side and adds its output, through the use's own
linear, to that layer's input only: ``h + mamba(norm(h + t))``; K/V a
use, SSM and conv state a layer, the embeddings ``x0`` carried along).

The reference stacks each parameter over a scanned layer axis (hybrids over
``(L/every, every)``) and runs ``lax.scan``; here a :class:`Model` holds one
module per layer in an ``nn.ModuleList`` and a Python loop walks them, one
scan step at a time (a block, or a hybrid's super-layer of ``every`` Mamba2
blocks and the shared block).  The reference's ``_maybe_remat`` becomes
``torch.utils.checkpoint`` around that same step when ``cfg.remat ==
"full"`` and autograd records.  The reference's ``logical_constraint``
sites are kept (``launch.partitioning``): inside a mesh context they
redistribute DTensors, outside one they return their input.

Entry points, with the reference's names:

* :func:`init_params` — a randomly initialised :class:`Model` on the card
  (``device=None``) or where asked;
* :func:`param_shapes` / :func:`param_specs` — ``{parameter name: shape}``
  and ``{parameter name: logical axes}``; :func:`tree_specs` the axes in the
  reference's stacked tree (its ``param_specs``);
* :func:`load_jax_params` — the reference's parameter tree, as numpy
  arrays, as a :class:`Model`;
* :func:`cache_shapes` / :func:`init_cache` — the serving cache, a dict
  with the reference's keys, shapes and dtypes; :func:`cache_specs` its
  logical axes (the reference dry run's);
* :func:`prefill` / :func:`decode_step` — run where the model's parameters
  are.  ``decode_step`` updates the cache's tensors in place and returns
  the same dict.  Under tracing (:mod:`repro_torch.obs.trace`) a decode
  step is a root span, ``model.decode_step``, over the host's issue of its
  work (it reads nothing from the device), whose children are the blocks'
  ``attention`` and ``moe.*`` spans;
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
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch.partitioning import (gathered, logical_constraint,
                                             shard_index)
from repro_torch.models.attention import update_positions
from repro_torch.models.blocks import (CONV_KW, DenseBlock, Mamba2Block,
                                      MoEBlock, SharedBlock, dense_block_defs,
                                      mamba2_block_defs, moe_block_defs,
                                      shared_block_defs, use_param_defs)
from repro_torch.models.config import ModelConfig, Zamba2Config
from repro_torch.models.layers import embed_lookup, rmsnorm
from repro_torch.models.params import ParamDef, ParamModule, init_param
from repro_torch.obs import trace as _obs

__all__ = ["Model", "init_params", "load_jax_params", "decayed",
           "param_defs", "param_shapes", "param_specs", "tree_specs",
           "export_tree", "import_tree", "tree_shapes", "cache_shapes",
           "cache_specs", "init_cache", "prefill", "decode_step",
           "forward_train"]

_ATTN = ("dense", "vlm", "audio")   # stacks of dense blocks
_KV = ("dense", "moe", "vlm")       # one k/v cache entry per layer


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _ATTN + ("moe", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if _zamba(cfg):
        ids = cfg.hybrid_layer_ids
        if cfg.family != "hybrid" or cfg.shared_attn_every \
                or cfg.sliding_window is not None \
                or cfg.num_mem_blocks < 1 or not ids \
                or list(ids) != sorted(set(ids)) \
                or not 0 <= ids[0] <= ids[-1] < cfg.n_layers:
            raise ValueError(
                f"Zamba2's form takes the hybrid family, increasing "
                f"hybrid_layer_ids below n_layers {cfg.n_layers}, "
                f"num_mem_blocks >= 1, no shared_attn_every and no "
                f"sliding_window; got {cfg.family}, {ids}, "
                f"{cfg.num_mem_blocks}, {cfg.shared_attn_every}, "
                f"{cfg.sliding_window}")
        return
    if cfg.family == "hybrid" and cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"shared_attn_every {cfg.shared_attn_every}")


def _zamba(cfg: ModelConfig) -> bool:
    """Zamba2's own form of the hybrid."""
    return isinstance(cfg, Zamba2Config)


def _stacked(cfg: ModelConfig) -> bool:
    """The reference's hybrid: its blocks in a ``(L/every, every)`` stack."""
    return cfg.family == "hybrid" and not _zamba(cfg)


def _n_scan(cfg: ModelConfig) -> int:
    """The reference's scan length (super-layers for a hybrid in its
    form)."""
    if _stacked(cfg):
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def _uses(cfg: ModelConfig) -> Dict[int, int]:
    """Zamba2's form: ``{Mamba2 layer: use}`` of the shared blocks."""
    return ({i: u for u, i in enumerate(cfg.hybrid_layer_ids)}
            if _zamba(cfg) else {})


def _block_of(cfg: ModelConfig, u: int) -> int:
    """The shared block that use ``u`` runs: they alternate."""
    return u % cfg.num_mem_blocks


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _top_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, V = cfg.d_model, cfg.vocab
    return {"embed": ParamDef((V, D), ("vocab", "embed_fsdp")),
            "final_ln": ParamDef((D,), (None,), init="ones"),
            "head": ParamDef((D, V), ("embed_fsdp", "vocab"))}


def _block_defs(cfg: ModelConfig) -> Dict[str, Dict[str, ParamDef]]:
    if cfg.family in _ATTN:
        return dense_block_defs(cfg)
    if cfg.family == "moe":
        return moe_block_defs(cfg)
    return mamba2_block_defs(cfg)


class Model(nn.Module):
    """embed, one block per layer, (hybrid) the shared block (Zamba2's
    form: ``shared.0`` .. and ``uses.0`` .., each use's adapter and
    linear), final_ln, head; parameter names follow the reference's tree
    (``blocks.3.mamba.in_proj`` ↔ ``params["blocks"]["mamba"]["in_proj"]
    [3]``)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator], device):
        _check_family(cfg)
        super().__init__()
        self.cfg = cfg
        top = _top_defs(cfg)
        self.embed = nn.Parameter(init_param(top["embed"], generator,
                                             device))
        block = (DenseBlock if cfg.family in _ATTN else
                 MoEBlock if cfg.family == "moe" else Mamba2Block)
        self.blocks = nn.ModuleList(block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        if _zamba(cfg):
            self.shared = nn.ModuleList(
                SharedBlock(cfg, generator, device)
                for _ in range(cfg.num_mem_blocks))
            self.uses = nn.ModuleList(
                ParamModule(use_param_defs(cfg), generator, device)
                for _ in cfg.hybrid_layer_ids)
        elif cfg.family == "hybrid":
            self.shared = DenseBlock(cfg, generator, device)
        self.final_ln = nn.Parameter(init_param(top["final_ln"], generator,
                                                device))
        self.head = nn.Parameter(init_param(top["head"], generator, device))


def param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """``{parameter name: ParamDef}`` in :class:`Model`'s order (its
    ``named_parameters``), without building it."""
    _check_family(cfg)
    out = dict(_top_defs(cfg))  # a module's own parameters come first

    def add(prefix, defs):
        for sub, group in defs.items():
            for name, d in group.items():
                out[f"{prefix}.{sub}.{name}"] = d

    for i in range(cfg.n_layers):
        add(f"blocks.{i}", _block_defs(cfg))
    if _zamba(cfg):
        for b in range(cfg.num_mem_blocks):
            add(f"shared.{b}", shared_block_defs(cfg))
        for u in range(len(cfg.hybrid_layer_ids)):
            out.update({f"uses.{u}.{name}": d
                        for name, d in use_param_defs(cfg).items()})
    elif cfg.family == "hybrid":
        add("shared", dense_block_defs(cfg))
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """``{parameter name: shape}`` (float32 masters)."""
    return {k: d.shape for k, d in param_defs(cfg).items()}


def param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """``{parameter name: logical axes}``, the reference's declarations."""
    return {k: d.axes for k, d in param_defs(cfg).items()}


def tree_specs(cfg: ModelConfig) -> Dict:
    """:func:`param_specs` in the reference's stacked tree (its
    ``param_specs``): a block parameter gains one unsharded "layer" axis
    per stacked dimension."""
    out: Dict = {}
    for name, axes in param_specs(cfg).items():
        path, idx = _ref_path(cfg, name)
        if idx and idx != (0,) * len(idx):
            continue
        _put(out, path, (("layer",) * len(idx)) + tuple(axes))
    return out


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
    idx = (i // every, i % every) if _stacked(cfg) else (i,)
    return ("blocks",) + parts[2:], idx


def _stack_shape(cfg: ModelConfig) -> tuple:
    if _stacked(cfg):
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
    arrays are copies on the host; a DTensor's is the whole tensor,
    gathered over its mesh (a collective: every rank of the mesh calls
    this)."""
    out: Dict = {}
    stacks: Dict = {}
    for name, t in named.items():
        path, idx = _ref_path(cfg, name)
        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        arr = t.cpu().numpy()
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
    hybrid's ``(L/every, every)`` double stack); a DTensor takes its own
    shards of each whole array.  Raises if a shape differs or a leaf of the
    tree has no counterpart."""
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
            src = torch.from_numpy(arr)
            if isinstance(t, DTensor):
                src = distribute_tensor(src.to(t.to_local().device),
                                        t.device_mesh, t.placements,
                                        src_data_rank=None)
            t.copy_(src)
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
    ``cache_shapes``: k/v per attention application (Zamba2's form: a use),
    one ``kv_positions`` shared by all of them, float32 SSM states and
    compute-dtype conv tails per Mamba2 block; empty for an encoder-only
    (audio) model."""
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
        nl = (L, cfg.shared_attn_every) if _stacked(cfg) else (L,)
        out["ssm"] = (nl + (batch, H, P, N), torch.float32)
        out["conv"] = (nl + (batch, CONV_KW - 1, conv_dim), dt)
    if cfg.family == "hybrid":
        cap = capacity if cfg.sliding_window is None else min(
            capacity, cfg.sliding_window)
        n_kv = len(cfg.hybrid_layer_ids) if _zamba(cfg) else L
        out["k"] = ((n_kv, batch, cap, K, hd), dt)
        out["v"] = ((n_kv, batch, cap, K, hd), dt)
        out["kv_positions"] = ((batch, cap), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, model_size: int) -> Dict[str, tuple]:
    """``{name: logical axes}`` of the serving cache on a mesh whose
    ``model`` axis has ``model_size`` devices, as the reference's dry run
    (``launch/dryrun.py::_cache_axes``): k/v shard by KV heads, or by
    sequence (flash-decoding style) when the heads do not divide."""
    out = {}
    for name, (shape, _) in cache_shapes(cfg, 1, 1).items():
        nd = len(shape)
        if name in ("k", "v"):
            out[name] = (("layer", "batch", None, "kv_heads", None)
                         if cfg.n_kv_heads % model_size == 0 else
                         ("layer", "batch", "kv_seq", None, None))
        elif name == "kv_positions":
            out[name] = ("batch", None)
        elif name == "ssm":
            out[name] = ("layer",) * (nd - 4) + ("batch", "ssm_heads",
                                                  None, None)
        else:  # conv
            out[name] = ("layer",) * (nd - 3) + ("batch", None, "ssm_inner")
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
        h = batch["embeds"].to(_dtype(cfg.dtype))
    else:
        h = embed_lookup(model.embed, batch["tokens"], _dtype(cfg.dtype))
    return logical_constraint(h, "batch", None, None)


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
    def sp(x):
        """The residual carry between blocks: batch-sharded, whole over
        ``model`` (Megatron's layout; a DTensor's sums left partial by a
        row-parallel product are reduced here), or with
        ``cfg.seq_parallel`` seq-sharded over ``model`` (Megatron-SP
        analogue: the tensor saved between blocks)."""
        if cfg.seq_parallel:
            return logical_constraint(x, "batch", "seq_sp", None)
        return logical_constraint(x, "batch", None, None)

    def step_h_aux(x, blocks, shared):
        out = _scan_step(cfg, blocks, shared, x, positions, False)
        return sp(out[0]), out[-1]

    h = sp(h)
    if _zamba(cfg):
        return _zamba_seq(model, cfg, h, positions, collect_cache, remat, sp)
    kvs, ssms, convs, auxs = [], [], [], []
    for blocks, shared in _scan_steps(model, cfg):
        if remat:
            h, aux = checkpoint(step_h_aux, h, blocks, shared,
                                use_reentrant=False)
            auxs.append(aux)
            continue
        h, kv, ssm, conv, aux = _scan_step(cfg, blocks, shared, h,
                                           positions, collect_cache)
        h = sp(h)
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


def _zamba_seq(model: Model, cfg: ModelConfig, h, positions,
               collect_cache: bool, remat: bool, sp):
    """:func:`_forward_seq` of Zamba2's form: a step a Mamba2 layer, led by
    a use of a shared block where ``hybrid_layer_ids`` names the layer; the
    embeddings ``x0`` are the input ``h``.  ``sp`` lays out the carry."""
    x0, uses = h, _uses(cfg)
    kvs, ssms, convs = [], [], []

    def layer(i, h):
        t = kv = None
        if i in uses:
            u = uses[i]
            b = _block_of(cfg, u)
            t, kv = model.shared[b](model.uses[u], h, x0, positions, u=u,
                                    block=b, return_kv=collect_cache)
        h, ssm, conv = model.blocks[i](h, t)
        return sp(h), kv, ssm, conv

    for i in range(cfg.n_layers):
        if remat:
            h = checkpoint(lambda x, i=i: layer(i, x)[0], h,
                           use_reentrant=False)
            continue
        h, kv, ssm, conv = layer(i, h)
        if kv is not None:
            kvs.append(kv)
        ssms.append(ssm)
        convs.append(conv)
    if not collect_cache:
        return h, None, {}
    return h, {"kv": kvs, "ssm": ssms, "conv": convs}, {}


def _head_logits(model: Model, cfg: ModelConfig, h) -> torch.Tensor:
    """float32 logits of compute-dtype activations and head, as the
    reference's ``preferred_element_type=float32``."""
    h = rmsnorm(h, model.final_ln, cfg.norm_eps)
    return h.float() @ gathered(model.head, h.dtype).float()


def _fused_head_ce(model: Model, cfg: ModelConfig, h: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """The reference's fused LM head + cross entropy, with its roundings:
    the logits are rounded to the compute dtype before the max and the
    exponent, and the gold logit is ``h · head[:, label]`` in float32 (a
    gather of head columns, not of the logits)."""
    h = logical_constraint(rmsnorm(h, model.final_ln, cfg.norm_eps),
                           "batch", None, None)
    head = gathered(model.head, h.dtype)
    # in bf16 one rounding of the float32 accumulation, as the reference's
    # einsum(preferred_element_type=float32).astype(h.dtype)
    logits = logical_constraint(h @ head, "batch", None, "vocab")
    # over a mesh the max is taken without its gradient, which is zero
    # (1 - the softmax's sum), as Megatron's vocab-parallel cross entropy
    m = torch.amax(logits.detach() if isinstance(logits, DTensor)
                   else logits, dim=-1)
    ex = torch.exp((logits - m[..., None]).float())
    lse = m.float() + torch.log(logical_constraint(torch.sum(ex, dim=-1),
                                                   "batch", None))
    if isinstance(head, DTensor):
        return torch.mean(lse - _sharded_gold(h, head, labels))
    return torch.mean(lse - _gold(h, head, labels))


def _gold(h, head, labels):
    """float32 ``h · head[:, label]`` (B, S): a gather of head columns, not
    of the logits."""
    Bsz, S = labels.shape
    # advanced indexing: its backward accumulates deterministically on CUDA
    gold_cols = head[:, labels.reshape(-1).long()]             # (D, B*S)
    gold_cols = gold_cols.T.reshape(Bsz, S, head.shape[0])
    return torch.sum(h.float() * gold_cols.float(), dim=-1)


def _sharded_gold(h, head, labels):
    """:func:`_gold` of DTensors, vocab-parallel (Megatron): each device
    reads the head columns of the labels in its vocabulary slice, and the
    partial sums reduce over the mesh axes that split the vocabulary."""
    mesh = head.device_mesh
    vocab_dims = [i for i, p in enumerate(head.placements) if p == Shard(1)]
    row_pl = [p if p == Shard(0) else Replicate() for p in h.placements]
    out_pl = [Partial() if i in vocab_dims else p
              for i, p in enumerate(row_pl)]

    def local(hl, headl, labl):
        lab = labl.long() - shard_index(mesh, vocab_dims) * headl.shape[1]
        mine = (lab >= 0) & (lab < headl.shape[1])
        return _gold(hl, headl, torch.where(mine, lab, 0)) * mine

    head_pl = [Shard(1) if i in vocab_dims else Replicate()
               for i in range(len(head.placements))]
    # h is whole on every vocabulary device, each of which reads it for
    # its own labels, and the head whole on every batch shard, each of
    # which reads it for its own tokens: their gradients are partial sums
    head_grad = [Partial() if p == Shard(0) else q
                 for p, q in zip(row_pl, head_pl)]
    gold = local_map(local, out_placements=out_pl,
                     in_placements=(row_pl, head_pl, row_pl),
                     in_grad_placements=(out_pl, head_grad, row_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        h, head, labels)
    return gold.redistribute(mesh, row_pl)


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
        if _stacked(cfg):
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
    if _obs.enabled:
        with _obs.span("model.decode_step", B=pos.shape[0]):
            return _decode_step(model, cfg, batch, cache, pos)
    return _decode_step(model, cfg, batch, cache, pos)


def _decode_step(model, cfg, batch, cache, pos):
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
    stacked = _stacked(cfg)
    x0, uses = h, _uses(cfg)        # Zamba2's form: the token's embedding
    for i, blk in enumerate(model.blocks):
        if cfg.family in _KV:
            h = blk.decode(h, pos, cache["k"][i], cache["v"][i],
                           kv_positions, window=window)
            continue
        t = None
        if i in uses:
            u = uses[i]
            b = _block_of(cfg, u)
            t = model.shared[b].decode(model.uses[u], h, x0, pos,
                                       cache["k"][u], cache["v"][u],
                                       kv_positions, u=u, block=b)
        idx = (i // every, i % every) if stacked else (i,)
        h, conv, ssm = blk.decode(h, cache["conv"][idx], cache["ssm"][idx],
                                  t)
        cache["conv"][idx] = conv
        cache["ssm"][idx] = ssm
        if stacked and (i + 1) % every == 0:
            j = i // every
            h = model.shared.decode(h, pos, cache["k"][j], cache["v"][j],
                                    kv_positions, window=window)
    return _head_logits(model, cfg, h), cache
