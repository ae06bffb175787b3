"""Traffic kind ``serve_batches``: a closed loop of static batches.

``clients`` clients each wait for their reply, so a batch of ``clients``
requests starts when the last one ended: a prefill through
``runtime.make_prefill_step`` (capacity for the longest answer), then
greedy decode steps through ``make_decode_step`` until the batch's longest
request has its tokens.  Every step ends in the host read of its tokens,
as a server streams them.  One prompt length a batch, since ``prefill``
takes one length per call.

Sizes are the same for every seed: prompt lengths are ``levels`` quantiles
of the mix's distribution, run in a fixed cycle that takes the longest,
the shortest, the next longest, and so on (so the check's batch of the
longest prompt is the first); output lengths are ``levels`` quantiles,
dealt to the clients in an order the seed draws.
The seed draws the prompts' token ids (uniform over the vocabulary).

End to end, as vLLM's ``benchmark_serving`` counts total throughput: a
batch's prompt tokens count once its prefill's tokens reached the host,
output tokens as each step produces them, only for requests that have not
ended; time to first token runs from the batch's start to the host read of
its first tokens.  No batch starts after ``seconds``, and the window ends
when the last batch started has its answers: the window holds whole
batches only, so the count of prefills in it cannot jump at its close.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from perfbench import weights as W
from perfbench.program import build_model


def _levels(d: dict) -> list:
    """The sizes a distribution spec stands for, ascending."""
    if "fixed" in d:
        return [d["fixed"]]
    median, sigma = d["lognormal"]
    n, mult = d["levels"], d.get("multiple", 1)
    out = []
    for i in range(n):
        z = statistics.NormalDist().inv_cdf((i + 0.5) / n)
        x = min(max(median * float(np.exp(sigma * z)), d["min"]), d["max"])
        out.append(int(-(-round(x) // mult) * mult))
    return sorted(out)


def prompt_cycle(t: dict) -> list:
    """Prompt lengths in their fixed cycle: longest, shortest, next ..."""
    lv = _levels(t["prompt"])
    out = []
    while lv:
        out.append(lv.pop())
        if lv:
            out.append(lv.pop(0))
    return out


def plan(t: dict, seed: int, i: int):
    """``(prompt length, output length of each client)`` of batch ``i``."""
    cycle = prompt_cycle(t)
    S = cycle[i % len(cycle)]
    outs = _levels(t["output"])
    if len(outs) == 1:
        return S, outs * t["clients"]
    if len(outs) != t["clients"]:
        raise ValueError("output levels must be one, or one a client")
    rng = np.random.default_rng([int(seed) % 2 ** 63, i])
    return S, [outs[j] for j in rng.permutation(len(outs))]


def prompts(ctx) -> list:
    """The pool of prompt batches (token ids on the device); batch ``i``
    takes entry ``i % len``, whose length is its own."""
    t = ctx.traffic
    cycle = prompt_cycle(t)
    n = len(cycle) * -(-t["pool"] // len(cycle))
    g = W.generator(ctx.seed, ctx.device, 1)
    return [torch.randint(0, ctx.spec["model"]["vocab"],
                          (t["clients"], cycle[i % len(cycle)]), generator=g,
                          device=ctx.device, dtype=torch.int32)
            for i in range(n)]


def setup(ctx):
    import time

    from repro_torch.runtime import make_decode_step, make_prefill_step
    t = ctx.traffic
    defs = ctx.reference.param_defs(ctx.spec["model"])
    model = build_model(ctx.cfg, W.make(defs, ctx.seed, ctx.device))
    longest = max(_levels(t["output"]))
    pool = prompts(ctx)
    fill = {S: make_prefill_step(ctx.cfg, capacity=S + longest)
            for S in set(prompt_cycle(t))}
    st = {"model": model, "pool": pool, "prefill": fill,
          "decode": make_decode_step(ctx.cfg)}
    for S in prompt_cycle(t):   # every shape the window will run
        toks = next(p for p in pool if p.shape[1] == S)
        _batch(st, toks, S, min(longest, 3), time.perf_counter, None)
    return st


def _batch(st, toks, S, n, clock, tracer):
    """Serve one batch: a prefill and ``n - 1`` decode steps, each ending
    in the host read of its tokens.  Returns the host tokens read and the
    times ``(start, end)`` of each step."""
    model, B = st["model"], toks.shape[0]
    times, served = [], []
    tb = clock()
    if tracer:
        tracer.mark("prefill")
    logits, cache = st["prefill"][S](model, {"tokens": toks})
    tok = logits[:, -1].argmax(-1)
    served.append(tok.cpu())
    times.append((tb, clock()))
    for j in range(1, n):
        ts = clock()
        if tracer:
            tracer.mark("decode")
        pos = torch.full((B,), S + j - 1, dtype=torch.int32,
                         device=toks.device)
        logits, cache = st["decode"](model, {"tokens": tok}, cache, pos)
        tok = logits[:, -1].argmax(-1)
        served.append(tok.cpu())
        times.append((ts, clock()))
    return torch.stack(served, dim=1), times


def window(ctx, st, clock, tracer):
    t = ctx.traffic
    B = t["clients"]
    t0 = clock()
    deadline = t0 + ctx.seconds
    ttft, prefills, decodes, shapes, done = [], [], [], [], []
    prompt_tok = output_tok = started = 0
    end = t0
    i = 0
    while clock() < deadline:
        S, outs = plan(t, ctx.seed, i)
        n = max(outs)
        toks = st["pool"][i % len(st["pool"])]
        served, times = _batch(st, toks, S, n, clock, tracer)
        started += B
        (tb, tf), steps = times[0], times[1:]
        ttft += [tf - tb] * B
        prefills.append((tb, tf))
        shapes.append([B, S])
        decodes += steps
        prompt_tok += B * S
        output_tok += sum(outs)
        end = times[-1][1]
        done.append({"i": i, "S": S, "outs": outs, "served": served})
        i += 1
    return {"t0": t0, "t1": end, "attempted": started, "failed": 0,
            "spans": {"prefill": prefills, "decode": decodes},
            "shapes": {"prefill": shapes},
            "totals": {"prompt_tokens": prompt_tok,
                       "output_tokens": output_tok, "ttft_s": ttft},
            "finished": done}


def end_to_end(ctx, w):
    tot = w["totals"]
    return {"serve_tokens_per_s": (tot["prompt_tokens"] + tot["output_tokens"])
            / (w["t1"] - w["t0"]),
            "ttft_p95_ms": float(np.percentile(tot["ttft_s"], 95)) * 1e3}


def sample(ctx, finished: list) -> list:
    """The finished batches the check compares: the one with the longest
    prompt, then others drawn from the seed until ``sample_tokens`` served
    tokens are in the sample."""
    if not finished:
        return []
    longest = max(finished, key=lambda b: (b["S"], -b["i"]))
    out = [longest]
    rest = [b for b in finished if b is not longest]
    order = np.random.default_rng([int(ctx.seed) % 2 ** 63, 7]).permutation(
        len(rest))
    for j in order:
        if sum(sum(b["outs"]) for b in out) >= ctx.traffic["sample_tokens"]:
            break
        out.append(rest[j])
    return out


def release(st, w):
    st.clear()
    return w["finished"]


def served_gaps(ctx, batches, control=False):
    """The gaps by which each served token's logit lies below the float32
    reference's best at its position, over every served token of
    ``batches`` (``(prompts, outs, served)``): ``served_gap`` the widest,
    ``served_gap_mean`` their mean.  With ``control``, also the same of the
    tokens that the reference in float8 puts first (the control: one
    precision below the configuration's).  Returns ``{"program": {...}}``
    and with ``control`` ``{"control": {...}}`` beside it."""
    ref, m = ctx.reference, ctx.spec["model"]
    params = W.make(ref.param_defs(m), ctx.seed, ctx.device)
    gaps = {"program": [], "control": []}
    for toks, outs, served in batches:
        served = served.to(toks.device)
        want = ref.serve_logits(params, m, toks, served)
        alive = torch.arange(served.shape[1], device=want.device)[None] \
            < torch.as_tensor(outs, device=want.device)[:, None]

        def gap(pick):
            g = want.max(-1).values - torch.gather(want, 2,
                                                   pick[..., None])[..., 0]
            return g[alive].cpu()

        gaps["program"].append(gap(served.long()))
        if control:
            low = ref.serve_logits(params, m, toks, served, "fp8")
            gaps["control"].append(gap(low.argmax(-1)))
            del low
        del want
    return {side: {"served_gap": float(torch.cat(g).max()),
                   "served_gap_mean": float(torch.cat(g).mean())}
            for side, g in gaps.items() if g}


def checked_batches(ctx, kept) -> list:
    pool = prompts(ctx)
    return [(pool[b["i"] % len(pool)], b["outs"], b["served"])
            for b in sample(ctx, kept)]


def check(ctx, kept) -> dict:
    batches = checked_batches(ctx, kept)
    if not batches:
        return {"served_gap": float("inf"), "served_gap_mean": float("inf")}
    return served_gaps(ctx, batches)["program"]
