"""Train and serve step functions, counterparts of the reference's
``runtime/steps.py``.

PyTorch runs eagerly, so a step is the model call with the config bound.
:func:`make_train_step`'s step updates the parameters and the AdamW state
in place, PyTorch's counterpart of the reference's donated buffers, and
returns the metrics; given DTensor parameters (a mesh) it first lays each
gradient out as its parameter (the data-parallel reduction, the
reference's ``out_shardings``).  :func:`make_encode_step` is an
encoder-only model's (hubert's) "prefill": the full forward to every
frame's logits.

:func:`make_decode_step`'s step replays one CUDA graph of
``models.decode_step`` per shape on the card, where issuing a step's
~1,000-2,500 operations one by one takes the host longer than the card
takes to run them.  :data:`GRAPHS` counts what it did.
"""

from __future__ import annotations

import sys
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import (decode_attention, dryrun, flash_attention,
                                 mamba2_mix, ssd)
from repro_torch.models import decayed, decode_step, forward_train, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (_default_positions, _embed_inputs,
                                      _forward_seq, _head_logits)
from repro_torch.obs import trace as _obs
from repro_torch.optim import adamw_update, cosine_schedule

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "make_encode_step", "step_fn_for", "GRAPHS"]

# What the decode steps did: graphs captured and replayed, caches copied
# into a graph's own ("adopt"), and calls run eagerly.
GRAPHS = {"capture": 0, "replay": 0, "adopt": 0, "eager": 0}
# The kernels' host-side launch counts; a replay adds what its capture moved.
_LAUNCH_COUNTS = (decode_attention.LAUNCHES, flash_attention.LAUNCHES,
                  ssd.LAUNCHES, mamba2_mix.LAUNCHES)
# A step's own working memory, beyond its static buffers, asked to be free
# before a capture (olmoe-1b-7b casts ~0.8 GB of experts a layer).
_SLACK = 2 << 30


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0):
    """``train_step(model, opt_state, batch, step) -> metrics``: loss and
    gradients of :func:`forward_train`, then one AdamW step at the cosine
    schedule's ``lr(step)``.  Metrics: ``loss``, ``ce_loss``, ``lr``,
    ``grad_norm`` and ``clip_scale`` (0-d tensors, ``lr`` a float), and an
    MoE model's aux terms."""
    lr_fn = cosine_schedule(peak_lr=peak_lr, warmup_steps=warmup_steps,
                            total_steps=total_steps)

    def train_step(model, opt_state, batch, step):
        params = dict(model.named_parameters())
        decay = decayed(cfg, params)
        loss, metrics = forward_train(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g
                 for g, p in zip(grads, params.values())]
        lr = lr_fn(step)
        stats = adamw_update(dict(zip(params, grads)), opt_state, params,
                             lr=lr, weight_decay=weight_decay,
                             clip_norm=clip_norm, decay=decay)
        return dict({k: v.detach() for k, v in metrics.items()}, lr=lr,
                    **stats)

    return train_step


def make_prefill_step(cfg: ModelConfig, capacity: Optional[int] = None):
    def prefill_step(model, batch):
        return prefill(model, cfg, batch, capacity=capacity)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``serve_step(model, batch, cache, pos) -> (logits, cache)``:
    :func:`models.decode_step`, replayed from a CUDA graph on the card.

    CPU tensors, DTensors (a mesh) and the dry run take ``decode_step``
    itself.  Otherwise each key (:func:`_key`: the device, the parameters'
    dtype, the shapes and dtypes of ``tokens`` or ``embeds``, ``pos`` and
    every cache leaf) owns a graph, its input buffers and its own cache.
    A key's first call runs the step eagerly on those buffers on a side
    stream (which also loads the kernels) and then captures it; later
    calls copy the (B,) inputs in and replay.  A cache that is not the
    key's own (a batch's first step after its prefill) is copied in once
    ("adopt") and the caller's dict is pointed at the key's tensors, so
    passing it back copies nothing; a dict that the key owned before and
    that its caller still holds first gets a copy of its state.  Logits
    are a fresh tensor each call.  A key whose buffers do not fit in the
    card's free memory evicts the least recently used graphs, or runs
    eagerly if it still does not fit.  The graphs read the parameters
    where they were at capture: update them in place (another model
    object drops every graph).  Graphs and buffers belong to the returned
    step and are freed with it."""
    return _GraphedDecode(cfg)


class _Graph:
    """One key's graph and the static tensors it reads and writes."""

    __slots__ = ("graph", "inputs", "pos", "cache", "logits", "launches",
                 "owner")

    def adopt(self, cache: Dict) -> None:
        """Copy ``cache`` into the key's own tensors and point it at them."""
        # references to the old owner: the slot, getrefcount's argument and
        # any caller's
        if self.owner is not None and self.owner is not cache \
                and sys.getrefcount(self.owner) > 2:
            for k, t in self.cache.items():
                if self.owner.get(k) is t:
                    self.owner[k] = t.clone()
        for k, t in self.cache.items():
            if cache[k] is not t:
                t.copy_(cache[k])
                cache[k] = t
        self.owner = cache


class _GraphedDecode:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._graphs: "OrderedDict[tuple, Optional[_Graph]]" = OrderedDict()
        self._model = None     # a weak reference to the graphs' model
        self._stream = None    # warm-ups and captures
        self._pool = None      # one memory pool for every graph

    def __call__(self, model, batch, cache, pos):
        name = "embeds" if "embeds" in batch else "tokens"
        x = batch[name]
        if x.device.type != "cuda" or dryrun.active() \
                or isinstance(x, DTensor) or isinstance(model.embed, DTensor):
            GRAPHS["eager"] += 1
            return decode_step(model, self.cfg, batch, cache, pos)
        if self._model is None or self._model() is not model:
            self._graphs.clear()
            self._model = weakref.ref(model)
        key = _key(model, batch, cache, pos)
        if key not in self._graphs:
            return self._capture(model, key, batch, cache, pos)
        g = self._graphs[key]
        if g is None:
            GRAPHS["eager"] += 1
            return decode_step(model, self.cfg, batch, cache, pos)
        self._graphs.move_to_end(key)
        if _obs.enabled:
            with _obs.span("model.decode_step", B=pos.shape[0], graph=1):
                return self._replay(g, x, cache, pos)
        return self._replay(g, x, cache, pos)

    def _replay(self, g: _Graph, x, cache, pos):
        g.inputs.copy_(x)
        g.pos.copy_(pos)
        if cache is not g.owner or any(cache[k] is not t
                                       for k, t in g.cache.items()):
            g.adopt(cache)
            GRAPHS["adopt"] += 1
            if _obs.enabled:
                _obs.count("decode_graph.adopt", 1)
        g.graph.replay()
        for counts, moved in zip(_LAUNCH_COUNTS, g.launches):
            for k, n in moved.items():
                counts[k] += n
        GRAPHS["replay"] += 1
        if _obs.enabled:
            _obs.count("decode_graph.replay", 1)
        return g.logits.clone(), cache

    def _fits(self, dev, nbytes: int) -> bool:
        """Whether ``nbytes`` of new static buffers fit beside a step's
        working memory, once least recently used graphs are evicted as
        needed."""
        def free():
            cached = torch.cuda.memory_reserved(dev) \
                - torch.cuda.memory_allocated(dev)
            return torch.cuda.mem_get_info(dev)[0] + cached
        graphs = [k for k, g in self._graphs.items() if g is not None]
        while nbytes + _SLACK > free() and graphs:
            del self._graphs[graphs.pop(0)]
        return nbytes + _SLACK <= free()

    def _capture(self, model, key, batch, cache, pos):
        """This call's step, run eagerly on the key's new buffers, then the
        key's graph captured."""
        name = "embeds" if "embeds" in batch else "tokens"
        x = batch[name]
        nbytes = sum(t.nbytes for t in cache.values()) + x.nbytes + pos.nbytes
        if not self._fits(x.device, nbytes):
            self._graphs[key] = None
            GRAPHS["eager"] += 1
            return decode_step(model, self.cfg, batch, cache, pos)
        g = _Graph()
        g.inputs, g.pos, g.owner = x.clone(), pos.clone(), None
        g.cache = {k: torch.empty_like(t) for k, t in cache.items()}
        g.adopt(cache)
        if self._stream is None:
            self._stream = torch.cuda.Stream(x.device)
            self._pool = torch.cuda.graph_pool_handle()
        s, here = self._stream, torch.cuda.current_stream(x.device)
        s.wait_stream(here)
        with torch.cuda.stream(s):
            logits, _ = decode_step(model, self.cfg, {name: g.inputs},
                                    g.cache, g.pos)
        here.wait_stream(s)
        before = [dict(c) for c in _LAUNCH_COUNTS]
        g.graph = torch.cuda.CUDAGraph()
        # capture_begin / end, not ``torch.cuda.graph``: its synchronise and
        # emptied allocator cache cost every later prefill its allocations
        with torch.cuda.stream(s):
            g.graph.capture_begin(pool=self._pool)
            try:
                g.logits, _ = decode_step(model, self.cfg, {name: g.inputs},
                                          g.cache, g.pos)
            finally:
                g.graph.capture_end()
        g.launches = []
        for counts, was in zip(_LAUNCH_COUNTS, before):
            g.launches.append({k: n - was[k] for k, n in counts.items()
                               if n != was[k]})
            counts.update(was)      # the capture launched nothing
        self._graphs[key] = g
        GRAPHS["capture"] += 1
        return logits, cache


def _key(model, batch: Dict, cache: Dict, pos: torch.Tensor) -> tuple:
    """What a decode step's graph depends on, read off its arguments."""
    name = "embeds" if "embeds" in batch else "tokens"
    x = batch[name]
    return (x.device, model.embed.dtype, name, tuple(x.shape), x.dtype,
            tuple(pos.shape), pos.dtype,
            tuple((k, tuple(t.shape), t.dtype) for k, t in cache.items()))


def make_encode_step(cfg: ModelConfig):
    """``encode_step(model, batch) -> logits (B, S, V)`` float32: every
    position's logits of ``embeds`` (or ``tokens``) through the whole model,
    without autograd or a cache."""
    @torch.no_grad()
    def encode_step(model, batch):
        h = _embed_inputs(model, cfg, batch)
        positions = batch.get("positions")
        if positions is None:
            positions = _default_positions(cfg, h.shape[0], h.shape[1],
                                           h.device)
        h, _, _ = _forward_seq(model, cfg, h, positions, collect_cache=False)
        return _head_logits(model, cfg, h)
    return encode_step


def step_fn_for(cfg: ModelConfig, kind: str) -> Callable:
    if kind == "train":
        return make_train_step(cfg)
    if kind == "prefill":
        return make_prefill_step(cfg)
    if kind == "encode":
        return make_encode_step(cfg)
    if kind == "decode":
        return make_decode_step(cfg)
    raise ValueError(kind)
