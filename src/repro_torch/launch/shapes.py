"""Assigned input shapes, per-cell applicability, and dry-run input specs.

Counterpart of the reference's ``launch/shapes.py``.  Shapes:
  train_4k    — seq 4,096  × global_batch 256   (training step)
  prefill_32k — seq 32,768 × global_batch 32    (inference prefill / encode)
  decode_32k  — 1 new token, KV len 32,768, global_batch 128
  long_500k   — 1 new token, context 524,288, global_batch 1

Cell policy (the reference's): long_500k runs only for sub-quadratic
families (ssm, hybrid), the hybrid's shared attention windowed to 4,096
there; decode shapes are skipped for encoder-only archs (hubert).  40
cells, 31 runnable.

:func:`input_specs` gives each input of the port's step functions as a
:class:`TensorSpec` (shape and dtype), which the dry run makes as a fake
tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models import cache_shapes
from repro_torch.models.config import ModelConfig

__all__ = ["ShapeCell", "SHAPES", "TensorSpec", "cell_supported",
           "cfg_for_cell", "input_specs", "step_kind"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, the counterpart of
    ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def _cell(shape) -> ShapeCell:
    """A name of :data:`SHAPES`, or a :class:`ShapeCell` as it is."""
    return shape if isinstance(shape, ShapeCell) else SHAPES[shape]


def cell_supported(cfg: ModelConfig, shape) -> Tuple[bool, str]:
    cell = _cell(shape)
    if cfg.is_encoder_only and cell.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    if cell.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch: 512k dense decode is "
                       "O(seq^2)/token with no sub-quadratic path")
    return True, ""


def cfg_for_cell(cfg: ModelConfig, shape) -> ModelConfig:
    """Per-cell config adaptation: hybrid long-context decode windows its
    shared attention to 4,096."""
    if _cell(shape).name == "long_500k" and cfg.family == "hybrid":
        return dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def step_kind(cfg: ModelConfig, shape) -> str:
    cell = _cell(shape)
    if cell.kind == "prefill" and cfg.is_encoder_only:
        return "encode"
    return cell.kind


def _token_specs(cfg: ModelConfig, batch: int, seq: int,
                 with_labels: bool) -> Dict[str, TensorSpec]:
    i32 = torch.int32
    out: Dict[str, TensorSpec] = {}
    if cfg.family in ("vlm", "audio"):
        out["embeds"] = TensorSpec((batch, seq, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = TensorSpec((batch, seq), i32)
    if with_labels:
        out["labels"] = TensorSpec((batch, seq), i32)
    if cfg.mrope_sections is not None:
        out["positions"] = TensorSpec((batch, seq, 3), i32)
    return out


def input_specs(cfg: ModelConfig, shape) -> Dict:
    """:class:`TensorSpec` stand-ins for every input of the cell's step
    function: ``{"batch": ...}``, and for decode ``"cache"`` and ``"pos"``.
    ``shape`` (here and above) is a name of :data:`SHAPES` or a
    :class:`ShapeCell`."""
    ok, why = cell_supported(cfg, shape)
    cell = _cell(shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {cell.name} unsupported: {why}")
    cfg = cfg_for_cell(cfg, shape)
    kind = step_kind(cfg, shape)
    if kind == "train":
        return {"batch": _token_specs(cfg, cell.batch, cell.seq, True)}
    if kind in ("prefill", "encode"):
        return {"batch": _token_specs(cfg, cell.batch, cell.seq, False)}
    # decode: one new token against a cache of capacity `seq`
    i32 = torch.int32
    batch: Dict[str, TensorSpec] = {}
    if cfg.family == "vlm":
        batch["embeds"] = TensorSpec((cell.batch, 1, cfg.d_model),
                                     torch.bfloat16)
    else:
        batch["tokens"] = TensorSpec((cell.batch,), i32)
    return {
        "batch": batch,
        "cache": {k: TensorSpec(tuple(s), dt) for k, (s, dt)
                  in cache_shapes(cfg, cell.batch, cell.seq).items()},
        "pos": TensorSpec((cell.batch,), i32),
    }
