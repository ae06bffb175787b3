"""Roofline analysis from the dry run (single-pod mesh), H100 constants.

Counterpart of the reference's ``launch/roofline.py``.  Terms per (arch ×
shape), in seconds per step, from one device's counts of
:func:`repro_torch.launch.dryrun.run_cell`:

    compute_s    = FLOPs / peak bf16 rate
    memory_s     = HBM bytes / HBM rate
    collective_s = per-card collective bytes / link rate: NVLink when every
                   collective group fits in one 8-card node, InfiniBand
                   otherwise (a 16-wide ``model`` axis spans two nodes)

plus MODEL_FLOPS (6·N_active·D for training; 2·N·D plus attention for
serving; the reference's formula), the useful-compute ratio MODEL_FLOPS /
counted FLOPs, the roofline fraction and, for a measured step time,
``mfu`` = MODEL_FLOPS / (chips × peak) / measured_s.  Hardware: ``HW`` of
:mod:`repro_torch.launch.mesh` (NVIDIA H100 SXM5).

The port's step runs layer by layer, so the dry run counts every layer
and needs no extrapolation: the longest cell (qwen2-vl-72b ``train_4k``)
traces in ~30 s on 8 CPU cores.  :func:`derive_terms` (the reference's
depth-reduction pair) is kept for parity: from dry runs at depth 1 and
``L_reduced`` it gives the full depth's totals exactly.

Usage:
  python -m repro_torch.launch.roofline --arch qwen3-1.7b --shape train_4k
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import HW
from repro_torch.launch.shapes import (SHAPES, ShapeCell, cell_supported,
                                       cfg_for_cell, step_kind)
from repro_torch.models.config import Zamba2Config

__all__ = ["roofline_cell", "roofline_terms", "model_flops", "derive_terms",
           "mfu"]


def _cell(shape) -> ShapeCell:
    return shape if isinstance(shape, ShapeCell) else SHAPES[shape]


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs for the cell (6·N·D convention)."""
    cell = _cell(shape)
    cfg = cfg_for_cell(cfg, cell)
    n_active = cfg.active_params_count() - cfg.vocab * cfg.d_model  # no embed
    kind = step_kind(cfg, cell)
    tokens = cell.batch * cell.seq

    # attention context FLOPs (score + value matmuls)
    def attn_flops(n_ctx_pairs):
        if cfg.family == "ssm" or not cfg.n_heads:
            return 0.0
        n_attn_layers = (
            len(cfg.hybrid_layer_ids) if isinstance(cfg, Zamba2Config) else
            cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid"
            else cfg.n_layers)
        return 4.0 * cfg.n_heads * cfg.hd * n_ctx_pairs * n_attn_layers

    if kind == "train":
        causal_pairs = cell.batch * cell.seq * (cell.seq + 1) / 2
        return 6.0 * n_active * tokens + 3.0 * attn_flops(causal_pairs)
    if kind in ("prefill", "encode"):
        pairs = cell.batch * cell.seq * (cell.seq + 1) / 2
        if not cfg.causal:
            pairs = cell.batch * cell.seq * cell.seq
        return 2.0 * n_active * tokens + attn_flops(pairs)
    # decode: one token per sequence against a cap-length context
    ctx = cell.seq if cfg.family != "hybrid" or cfg.sliding_window is None \
        else min(cell.seq, cfg.sliding_window)
    return 2.0 * n_active * cell.batch + attn_flops(cell.batch * ctx)


def derive_terms(full: Dict, scan0: Dict, unroll0: Dict, L: int,
                 L_reduced: int) -> Dict:
    """The reference's extrapolation: ``scan0`` counts the rest and one
    layer body, ``unroll0`` the rest and ``L_reduced`` bodies (in the port:
    dry runs at depth 1 and ``L_reduced``); totals at depth ``L``."""
    out = {}
    for key, full_key in [("flops", "flops_per_device"),
                          ("bytes", "bytes_per_device"),
                          ("hbm_bytes", "hbm_bytes_per_device")]:
        b = (unroll0[full_key] - scan0[full_key]) / (L_reduced - 1)
        rest = scan0[full_key] - b
        out[key] = rest + L * b
        out[key + "_body"] = b
    cb = (unroll0["collective"]["total_bytes"]
          - scan0["collective"]["total_bytes"]) / (L_reduced - 1)
    crest = scan0["collective"]["total_bytes"] - cb
    out["collective_bytes"] = crest + L * cb
    # fall back to raw values if the interpolation degenerates
    for k, fk in [("flops", "flops_per_device"),
                  ("bytes", "bytes_per_device"),
                  ("hbm_bytes", "hbm_bytes_per_device")]:
        if out[k] <= 0:
            out[k] = full[fk]
    if out["collective_bytes"] <= 0:
        out["collective_bytes"] = full["collective"]["total_bytes"]
    return out


def mfu(model_flops_: float, chips: int, measured_s: float) -> float:
    """Model-FLOPs utilisation of a measured step."""
    return model_flops_ / (chips * HW.PEAK_FLOPS_BF16) / measured_s


def _link_bw(rec: Dict) -> float:
    groups = rec["collective"].get("group_sizes") or [1]
    return HW.NVLINK_BW if max(groups) <= HW.CARDS_PER_NODE else HW.IB_BW


def roofline_terms(rec: Dict, cfg, shape, terms: Optional[Dict] = None,
                   measured_s: Optional[float] = None) -> Dict:
    """The roofline of one dry-run record ``rec`` (or of extrapolated
    ``terms``), with ``mfu`` when a measured step time is given."""
    terms = terms or dict(flops=rec["flops_per_device"],
                          bytes=rec["bytes_per_device"],
                          hbm_bytes=rec["hbm_bytes_per_device"],
                          collective_bytes=rec["collective"]["total_bytes"])
    chips = rec["n_devices"]
    compute_s = terms["flops"] / HW.PEAK_FLOPS_BF16
    memory_s = terms["hbm_bytes"] / HW.HBM_BW
    collective_s = terms["collective_bytes"] / _link_bw(rec)
    dominant = max([("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)], key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    total = terms["flops"] * chips
    step_s = max(compute_s, memory_s, collective_s)
    out = dict(
        chips=chips, flops_per_device=terms["flops"],
        bytes_per_device=terms["bytes"],
        hbm_bytes_per_device=terms["hbm_bytes"],
        collective_bytes_per_chip=terms["collective_bytes"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, step_s=step_s, model_flops=mf,
        useful_ratio=mf / total if total else 0.0,
        roofline_fraction=(mf / (chips * HW.PEAK_FLOPS_BF16)) / step_s
        if step_s > 0 else 0.0,
        peak_bytes_per_device=rec["memory"]["peak_bytes"],
        fits_hbm=bool(rec["memory"]["peak_bytes"] <= HW.HBM_BYTES),
        collective_per_op=rec["collective"]["per_op"])
    if measured_s is not None:
        out["measured_s"] = measured_s
        out["mfu"] = mfu(mf, chips, measured_s)
    return out


def roofline_cell(arch: str, shape,
                  out_dir: str = "experiments/roofline_torch",
                  dry_dir: str = "experiments/dryrun_torch",
                  cfg_override=None, tag: str = "", rules_patch=None, *,
                  measured_s: Optional[float] = None,
                  **dry_kw) -> Optional[Dict]:
    """Dry-run the cell on the single-pod mesh (``dry_kw`` go to
    :func:`run_cell`: ``mesh_shape``, ``param_dtype``) and write its
    roofline."""
    cfg = cfg_override or get_config(arch)
    cell = _cell(shape)
    ok, why = cell_supported(cfg, cell)
    cell_id = f"{arch}__{cell.name}" + (f"__{tag}" if tag else "")
    if not ok:
        rec = dict(cell=cell_id, status="skipped", reason=why)
        _write(out_dir, cell_id, rec)
        return rec

    full = run_cell(arch, cell, False, out_dir=dry_dir, cfg_override=cfg,
                    tag=tag, rules_patch=rules_patch, **dry_kw)
    rec = dict(cell=cell_id, arch=arch, shape=cell.name, status="ok",
               kind=full["kind"], mesh=full["mesh"],
               **roofline_terms(full, cfg, cell, measured_s=measured_s))
    _write(out_dir, cell_id, rec)
    print(f"ROOFLINE {cell_id}: comp {rec['compute_s']*1e3:.1f}ms mem "
          f"{rec['memory_s']*1e3:.1f}ms coll {rec['collective_s']*1e3:.1f}ms"
          f" -> {rec['dominant']} | useful {rec['useful_ratio']:.2f} frac "
          f"{rec['roofline_fraction']:.2f} | peak "
          f"{rec['peak_bytes_per_device']/2**30:.1f}GiB")
    return rec


def _write(out_dir, cell_id, rec):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--out", default="experiments/roofline_torch")
    args = ap.parse_args(argv)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    fails = []
    for a in archs:
        for s in shapes:
            try:
                roofline_cell(a, s, out_dir=args.out)
            except Exception as e:  # a failing cell is a bug: surface it
                fails.append((a, s, repr(e)))
                print(f"FAIL roofline {a}x{s}: {e!r}")
    if fails:
        raise SystemExit(f"{len(fails)} roofline cells failed")
    print("ROOFLINE COMPLETE")


if __name__ == "__main__":
    main()
