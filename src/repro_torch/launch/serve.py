"""Serving launcher: batched prefill + decode with KS+ admission control.

Requests with varying prompt lengths arrive in a queue; the server admits a
batch when the predicted memory envelope of (prefill spike → growing KV
cache) fits the device budget, then runs prefill and a decode loop.  The
envelope model is fit online from observed per-request memory curves —
the paper's observe → segment → predict loop applied to serving.

Envelope predictions go through :mod:`repro_torch.serve`: an in-process
:class:`~repro_torch.serve.PredictionServer` (``batching=False`` —
admission is a closed loop, one probe at a time) hosting a single
``kv-envelope`` family whose method is resolved by name through
:mod:`repro_torch.core.registry` (``--method``, default ``ks+``), not
constructed directly.  The model, its weights (from a seeded
``torch.Generator``) and the prediction server live on ``device`` (None
means the card).  Prompt lengths and tokens come from the same seeded numpy
stream as the JAX reference's launcher, so both admit the same batches.
A vlm model is fed its stubbed vision frontend's output: ``embeds`` with
3-axis positions at prefill, zero embeds at decode.  An encoder-only
(audio) model has no decode loop and raises ``SystemExit``, as the
reference's launcher does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --requests 12 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime import make_decode_step, make_prefill_step
from repro_torch.serve import PredictionServer

__all__ = ["serve_demo", "kv_envelope", "vlm_feed"]


def kv_envelope(cfg, batch: int, prompt: int, new_tokens: int) -> np.ndarray:
    """Analytic per-request memory-over-time curve (GB) for one batch:
    prefill spike, then linear KV growth during decode."""
    bytes_per_tok = 2 * cfg.n_kv_heads * cfg.hd * max(
        cfg.n_layers, 1) * 2  # k+v bf16
    kv0 = batch * prompt * bytes_per_tok / 2**30
    act_spike = batch * prompt * cfg.d_model * 4 * 2 / 2**30
    curve = [kv0 + act_spike]
    for t in range(new_tokens):
        curve.append(kv0 + batch * (t + 1) * bytes_per_tok / 2**30)
    return np.asarray(curve)


def vlm_feed(cfg, rng, Bsz: int, S: int, device) -> dict:
    """A vlm prompt batch as the stubbed frontend gives it: float32
    ``embeds`` (B, S, D) drawn from ``rng``, and every position id on all
    three M-RoPE axes, as the reference's launcher feeds it."""
    embeds = torch.as_tensor(rng.standard_normal((Bsz, S, cfg.d_model)),
                             dtype=torch.float32, device=device)
    pos = torch.arange(S, dtype=torch.int32, device=device)
    return {"embeds": embeds,
            "positions": pos[None, :, None].expand(Bsz, S, 3)}


def serve_demo(arch: str, *, requests: int = 12, max_batch: int = 4,
               prompt_lens=(32, 64, 96), new_tokens: int = 16,
               budget_gb: float = 2.0, seed: int = 0, method: str = "ks+",
               device=None):
    """Admit, prefill and greedily decode ``requests`` prompts of the
    smoke-size ``arch`` on ``device``; returns ``served`` / ``batches`` /
    ``elapsed_s``."""
    dev = resolve_device(device)
    cfg = smoke_config(arch)
    if cfg.is_encoder_only:
        raise SystemExit(f"{arch} is encoder-only; use encode benchmarks")
    rng = np.random.default_rng(seed)
    queue: List[int] = [int(rng.choice(prompt_lens)) for _ in range(requests)]
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                        device=dev)

    # Online envelope model over 'input size' = batch*prompt tokens,
    # served by the prediction service (method resolved via the registry).
    obs_m, obs_d, obs_i = [], [], []
    for b in (1, 2, max_batch):
        for p in prompt_lens:
            obs_m.append(kv_envelope(cfg, b, p, new_tokens))
            obs_d.append(1.0)
            obs_i.append(float(b * p))
    srv = PredictionServer(batching=False, device=dev)
    srv.add_tenant("admission")
    srv.seed_family("kv-envelope", method, obs_m, obs_d, obs_i)
    env = srv.client("admission")

    decode = make_decode_step(cfg)
    served = 0
    batches = 0
    t0 = time.time()
    with torch.no_grad():
        while queue:
            # Admission: largest batch whose predicted envelope peak fits.
            batch = []
            while queue and len(batch) < max_batch:
                cand = batch + [queue[0]]
                plan = env.predict("kv-envelope",
                                   float(len(cand) * max(cand)))
                if plan.peaks.max() > budget_gb and batch:
                    break
                batch.append(queue.pop(0))
            S = max(batch)
            Bsz = len(batch)
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (Bsz, S)),
                                   dtype=torch.int32, device=dev)
            feed = {"tokens": toks}
            if cfg.family == "vlm":
                feed = vlm_feed(cfg, rng, Bsz, S, dev)
            prefill = make_prefill_step(cfg, capacity=S + new_tokens)
            logits, cache = prefill(model, feed)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            for t in range(new_tokens):
                pos = torch.full((Bsz,), S + t, dtype=torch.int32,
                                 device=dev)
                db = ({"tokens": tok} if cfg.family != "vlm" else
                      {"embeds": torch.zeros((Bsz, 1, cfg.d_model),
                                             device=dev)})
                logits, cache = decode(model, db, cache, pos)
                tok = logits[:, -1].argmax(-1).to(torch.int32)
            served += Bsz
            batches += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dict(served=served, batches=batches,
                elapsed_s=round(time.time() - t0, 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--method", default="ks+",
                    help="registry name of the envelope model")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    print(json.dumps(serve_demo(args.arch, requests=args.requests,
                                new_tokens=args.new_tokens,
                                method=args.method, device=args.device),
                     indent=1))


if __name__ == "__main__":
    main()
