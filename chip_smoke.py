"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Whether each kernel is right lives in the ``cuda``-marked tests, which
phase 3 runs; the phases after it run the port at full width and time
it, and check only what a full-width run launched.

Phases (any failure exits non-zero; nothing is caught):

1. device line: the card's name and power limit from ``nvidia-smi``, and
   the torch / CUDA versions;
2. build: ``nvcc`` builds every kernel source from ``src/``, one process
   per source, all started together (seconds); this phase reports the
   wastage and the admission kernels' registers and spills;
3. the card tests: ``python -m pytest -q -m cuda tests/`` in a process of
   its own; every test passes and none skips;
4. main path at paper size: ``evaluate_workflow`` over the eager and sarek
   workflows with all 9 methods on the card, then with ``device="cpu"``
   (the plain path); chosen k per family, retries and failures must be
   equal, GB·s within the reference's own tolerances; exactly one
   ``fleet_engine`` launch per fleet call on the card and no probe launch;
5. main path at fleet scale: sarek with 2000 executions per family
   (20,000 executions) on the card: stage wall times, lanes, launches (as
   in phase 4), and the fit's and the replay's fleet calls timed apart
   (``FleetCalls``: each call ends in a synchronise);
6. ``fleet_engine`` against the plain engine at every group table phases 4
   and 5 launched: attempts and successes exact, wastage rtol 1e-4.  Then
   the wastage kernels are timed (CUDA events, median after warm-up, L2
   flushed) beside their byte bound and plain versions: both probes in
   one launch over phase 5's attempt-1 groups of the ks+ job (checked
   against the plain versions first), ``fleet_engine`` over the replay's
   table;
7. build of the LM kernels ``ssd.cu`` and ``flash_attention.cu`` (started
   in phase 2): build seconds, and for every bf16 kernel its registers and
   spills from ``ptxas -v`` and its count of ``HGMMA`` (tensor-core
   ``wgmma``) instructions from ``cuobjdump -sass``;
8. serving at full width: zamba2-2.7b (54 Mamba2 blocks, the shared
   attention block after every 6th), weights from ``init_params`` on the
   card with seed 0; ``serve_demo``'s loop (prefill, then greedy
   ``decode_step``) for 4 requests x 2048 tokens and 3 x 1000, 32 new tokens
   each, after one uncounted warm-up request.  Prefill seconds, decode
   tokens/s, peak memory; launches per prefill must be exactly one ``ssd``
   per Mamba2 block and one ``flash_attention`` per shared-block
   application (54 and 9), and none in decode; all logits finite.  Then
   one more 4 x 2048 prefill under ``profile_call`` (the benchmark's
   tracer): device ms by kernel kind, the top kernels and the idle share
   (1 - the union of the device's operations over the wall time) beside
   its wall time (the prefill split of ``PERF.md`` section 5);
9. card vs CPU at full width and reduced depth (6 Mamba2 blocks + the
   shared block), B = 1, S = 300 and 4 decode steps fed the same tokens:
   logits and every cache entry within 1e-3 in float32 (atol scaled down
   for tensors smaller than 1), and in bf16 within 3e-2 of each element
   plus 3e-2 of the tensor's largest value (see ``card_vs_cpu``);
10. LM kernel parity at every shape phase 8 launched, on seeded inputs;
   then each LM kernel is timed at the 4 x 2048 shapes beside its plain
   version, its bound (max of bf16 FLOPs at 989 TFLOP/s and bytes at
   3.35 TB/s) and, for attention, ``scaled_dot_product_attention``;
11. cluster replay at the reference benchmark's full size.  The
   ``workload_replay`` scenario (layered random DAG, 4 task families)
   synthesized on the card at 8192 tasks (seed 1), timed, and synthesized
   again to check it is bitwise the same; then replayed by
   ``ClusterSim(engine="fused")`` on four nodes (48, 64, 32, 96 GB) with
   ``RetrySpec("ksplus")``: release order against the DAG, no
   unschedulable job, exactly one ``oom_probe`` launch per dt group (the
   attempt-1 probe) and no other wastage launch, one ``admit_drain``
   launch per drain program and host reads = drain programs + column
   refreshes; wall seconds, drains, drain iterations and host reads,
   retries.  The same replay again with
   the node-sharded drain, ``shard=1`` on a one-rank process group over
   the card (two all-reduces a drain iteration): placements equal to the
   unsharded drain's; wall seconds, drains, iterations, host reads and
   collectives.  The reference's two admission benchmarks
   (``benchmarks/run.py``) through the port's ``AdmissionState`` at their
   sizes and seeds: ``bench_admission``'s script (10,000 lanes, K = 4,
   G = 64, four loaded nodes, 3 events of up to 12 admissions, each
   through a column refresh over the 9,968-deep queue: ``admit_columns``)
   and ``bench_drain``'s protocol (64 lanes drained at 0, 10, 40 and 90
   s: one ``admit_drain`` a drain), each on the card equal to the fused
   state on the CPU and to the numpy backend, launches counted as in the
   replay.  The same scenario at 400
   tasks (seed 0) through ``fused`` and ``packed`` on the card and
   ``legacy``: placements, retries and unschedulable identical, the
   fused engine equal to itself on the CPU over the carried trace, and
   ``fused`` with ``shard=1`` equal to ``fused`` and ``packed`` (every
   integer output and the makespan exact, wastage rtol 1e-6).  The
   robustness suite (3 scenarios x 2 arrivals x 3 fault kinds, 96 tasks)
   through ``run_suite`` on the card, each case replayed by ``fused`` and
   ``packed`` with equal placements, evictions, starved, doomed and
   retries.  ``evaluate_workflow("heavy_tail")`` on the card against the
   same trace carried to the CPU (retries and failures exact, GB·s rtol
   1e-4).  Then ``oom_probe`` at the replay's probe table against its
   plain version, and timed there; last, the 8 largest drains of the
   replay and the 8 largest column refreshes of ``bench_admission``'s
   script (copied when they ran), and the protocol's drains, held against
   the plain versions; the first two sets timed beside their bound (float64 at 34 TFLOP/s, bytes at 3.35 TB/s);
12. the prediction service (``repro_torch.serve``) on the card:
   (a) ``run_saturation()`` at its defaults (8 tenants, 2048 requests,
   2000 req/s open-loop, seed 0): batched plans bitwise equal to
   unbatched, no kernel build or load on the warm path, cache hits on
   repeat traffic; req/s, mean batch, p50/p99, hit rate, and one
   ``fleet_engine`` launch per ``fleet.engine`` dispatch; (b) a server
   of 8 tenants sharing one ``ks+`` snapshot per family of
   ``sarek(instances_per_family=2000)``, seeded on the family's 2000
   executions at dt 1.0: ``evaluate`` for every (tenant, family) and
   ``tune_offset`` for every family, cold and then warm under
   ``dispatch_budget(compiles=0)``; exactly one ``fleet_engine`` launch
   per evaluate dispatch and per tune group, ``serve.dev_sync`` once per
   (tenant, family, snapshot) cold and never warm; the same on a CPU
   server (``succeeded`` and ``mean_attempts`` exact, GB·s rtol 1e-4,
   the same best offset); seconds per call cold and warm; (c) the
   400-task ``workload_replay`` (seed 0, ``under_frac=0.2``) through the
   fused engine untraced and traced: placements, retries, evictions and
   wastage bitwise equal, one ``admission.drain`` dispatch per drain; the
   trace goes to ``build/obs_trace.perfetto.json`` and its top spans are
   printed; (d) ``serve_demo("qwen3-1.7b")`` on the card admits the same
   batches as on the CPU.  Then ``fleet_engine`` against the plain engine
   at every group table (b) launched, and timed at the one that moves the
   most bytes (the ``fleet_engine`` record's ``serve`` entry);
13. training on the card: (a) the backward kernels (built in phase 2 with
   the forwards, the same two sources) with registers and spills from
   ``ptxas -v`` and ``HGMMA`` counts from ``cuobjdump -sass``; (b) one
   ``train_step`` of the
   full-width model cut to 6 Mamba2 blocks + the shared block, B = 1,
   S = 300, card against CPU: the loss and every gradient, and every
   parameter after AdamW against the CPU's AdamW fed the card's gradients,
   at phase 9's tolerances, but for the bf16 per-head gradients
   (``A_log``, ``dt_bias``), held to a relative L2 error of 0.1 (see
   ``train_card_vs_cpu``); the card's forward launches one ``mix_in`` and
   one ``mix_out`` a Mamba2 layer, and in bf16, where the mix kernels
   round less often than the plain path, the card's gradients through
   them are held to be at least as near the float32 gradients (the same
   weights and batch, on the card) as the CPU's, each in relative L2,
   while those of the card's plain route meet the rules above; (c)
   ``launch.train.train("zamba2-2.7b", smoke=False,
   seq=2048, batch=1, steps=8)`` (``remat="none"``, as the reference's
   ``train``) on its local mesh, ``(1, 1)`` over the card: every
   parameter, AdamW moment and batch array a DTensor on that CUDA mesh;
   seconds per step (median after the first), tokens/s, peak
   memory, every loss finite, and exactly 54 ``ssd`` + 54 ``ssd_bwd``,
   54 ``mix_in`` + 54 ``mix_out`` (on the mesh's local shards) and 9
   ``flash_attention`` + 9 ``flash_attention_bwd`` launches in every
   step; its last step profiled (``profile_call``: device ms by kernel
   kind); then ``make_train_step`` with the config's own ``remat="full"``
   at 2 x 2048 for 3 steps, where the forward kernels launch twice a step;
   (d) zamba2-smoke trained on the card's mesh (DTensor parameters) with
   checkpoints every 3 steps, killed at step 5 and resumed: losses bitwise
   those of an uninterrupted run; (e) both backward kernels timed at the
   1 x 2048 training shapes (``ssd_bwd`` with the forward's saved
   entering states, as training calls it, and alone) beside their plain
   versions, their bounds, PR 17's times and, for attention, the
   backward of
   ``scaled_dot_product_attention``;
14. the moe, vlm and audio families: (a) olmoe-1b-7b at full width and
   depth (16 layers, 64 experts top-8), ``serve_demo``'s loop for 4 x 2048
   and 3 x 1000 prompts, 32 greedy tokens each, after a warm-up: prefill
   seconds, decode tokens/s, peak memory, each layer's
   ``moe_dropped_frac``; exactly 16 ``flash_attention`` launches per
   prefill, none in decode, no ``ssd``; logits finite; one 4 x 2048
   prefill profiled (``profile_call``: matmul, ``flash_attention``, the
   dispatch's sorts / gathers / scatters, other; idle share), and 8 decode
   steps at B 32, cap 1792 (the decode cell's) profiled eagerly and
   through ``make_decode_step``'s CUDA graph side by side
   (``decode_side_by_side``: ms a step, idle share); one MoE
   block called twice at the prefill's shape, bitwise equal (the combine
   has no atomics); (b) olmoe cut to 2 layers, B = 1, S = 300, 4 decode
   steps, card against CPU: in f32 every routing call identical (expert
   sets, slots, kept entries) and logits and caches at phase 9's rule;
   one bf16 MoE block on identical inputs, routing identical and output
   at phase 9's bf16 rule; the bf16 model's routing agreement share and
   the k-th / (k+1)-th probability gap where it disagrees, printed; one
   f32 ``train_step`` at the config's own ``remat="full"``, held as phase
   13 (b) (``train_card_vs_cpu``); (c) qwen2-vl-72b at full width cut to
   4 layers: ``serve_demo``'s vlm feed (2 x 2048 embeds, positions of a
   64-wide image grid: the temporal id fixed, height and width varying),
   16 decode steps fed zero embeds; exactly 4 ``flash_attention`` launches
   per prefill; then 1 layer, B = 1, S = 256 and 2 decode steps card
   against CPU in f32 (the host's free memory checked first); (d)
   hubert-xlarge at full width and depth (48 non-causal layers):
   ``step_fn_for(cfg, "encode")`` over 4 x 1500 frames, a warm-up at that
   shape, then three timed calls: seconds (median), frames/s, peak
   memory, exactly 48 ``flash_attention`` launches in each; 6 layers,
   S = 300, card against CPU in f32 and bf16; (e)
   ``flash_attention`` against its plain version (bf16, the tests'
   2e-2) at every shape (a), (c) and (d) launched, then timed there
   beside the plain version, its bound and ``scaled_dot_product_attention``
   with the same causality: the ``flash_attention`` record's ``families``
   field.  ``python3 -c "import chip_smoke; chip_smoke.families_bench()"``
   runs it alone with its build.

15. the dry run and the roofline (``launch.dryrun`` / ``launch.roofline``,
   on the host CPU with fake tensors): (a) the steps phases 8, 13 and 14
   ran at full width — zamba2-2.7b prefill 4 x 2048 and training 1 x 2048
   (``remat="none"``, the card's step on the same one-card mesh),
   olmoe-1b-7b prefill 4 x 2048, qwen2-vl-72b (4
   layers) prefill 2 x 2048 and hubert-xlarge encode 4 x 1500 — dry-run on
   a one-card mesh with the card's float32 masters: predicted FLOPs, HBM
   bytes, peak and the roofline's compute and memory seconds beside the
   card's time and memory of that step (``step_memory``: its
   ``max_memory_allocated`` less what else the process held), and each
   step's ``mfu``.  The card's time is a median of warm calls: of the 7
   training steps after the first, of hubert's 3 encodes, and for each
   prefill of ``WARM_RUNS`` prefills of the batch after an untimed one
   (``warm_prefill``, run by phases 8 and 14 after they read their launch
   counts, so those counts stay the served batches' own).  It fails if a
   one-card mesh issues a collective, if the bound exceeds the measured
   time by more than 5 % (a wrong count), or if the predicted peak misses
   the card's step peak by more than 20 % (a tensor left out or added);
   (b) the reference's tiny-mesh trio (qwen3-1.7b ``train_4k``,
   olmoe-1b-7b ``decode_32k``, mamba2-780m ``long_500k``) and the SSD
   path's mamba2-780m ``prefill_32k`` and zamba2-2.7b ``train_4k`` on the
   production (16, 16) mesh: per-device GiB, ``fits_hbm``, FLOPs,
   collective bytes by op and the dominant term, each ``ok``.  Records go
   to ``build/dryrun_torch/``.

16. decode attention (``kernels.decode_attention``) timed at the olmoe
   cells' decode shapes (B 32 at caps 1792
   and 960, B 8 at 3853; G 1, hd 128, every slot valid) beside its bound
   (``ops.io_bytes``), the plain version and, as ``library_ms``,
   ``scaled_dot_product_attention`` with an explicit mask on transposed
   copies of the same inputs (the port never calls it), and a layer's
   write + attention both ways on the cache in place, device ms and host
   us: the kernel's one call against ``append_kv``, the mask and SDPA on
   strided views: the ``decode_attention`` record.  Phases 8 and 14 count
   its launches, one per attention layer a decode step; the record's
   ``launches`` is phase 14's olmoe count.  ``python3 -c "import chip_smoke;
   chip_smoke.decode_attention_bench()"`` runs it alone with its build.

17. Zamba2-2.7B in Zyphra's form (``zamba2-2.7b-zyphra``: two shared
   blocks over the 5120-wide concatenation with the embeddings, hd 160,
   scale ``80 ** -0.5``; the ``zamba2-2.7b-serve-prefill`` cell's
   configuration) at full width, weights from ``init_params`` with seed 0:
   ``serve_demo``'s loop for 8 x 3840 and 8 x 768 prompts, 4 greedy tokens
   each, after a warm-up: exactly 54 ``ssd`` and 9 ``flash_attention``
   launches per prefill, 9 ``decode_attention`` launches per decode step,
   every attention call at Zyphra's scale, logits finite; 8 decode steps
   at B 8, cap 3853 profiled eagerly and graphed (``decode_side_by_side``).
   Then the bf16
   hd-160 ``flash_attention`` forward against its plain version (a batch
   row at a time; the tests' bf16 tolerance, 2e-2) at B 8 x {768, 1536,
   3840}, H 32, and ``decode_attention`` against its plain version at B 8,
   cap 3853, H = K = 32 (every slot valid, and rows part filled; the decode
   tests' bf16 tolerance, 1e-2), both at that scale; each timed there
   beside the plain version, its bound and
   ``scaled_dot_product_attention``: the ``zyphra`` field of the
   ``flash_attention`` and ``decode_attention`` records.  ``python3 -c "import chip_smoke; chip_smoke.zyphra_bench()"``
   runs it alone with its builds.

18. the Mamba2 mix kernels (``kernels.mamba2_mix``, ``mix_in`` and
   ``mix_out`` around the SSD scan) timed at Zyphra's widths, B 8 x {768,
   1536, 3840}, beside their byte bound (``ops.io_bytes``) and the plain
   route; then Zyphra's
   form at full width, a prefill of 8 x {3840, 1536, 768} tokens: exactly
   54 ``mix_in`` and 54 ``mix_out`` launches a prefill, and where its
   device time goes (CUDA events around the program's pieces on its one
   stream, 3 warm prefills a shape: the mixers without the scan and,
   inside them, ``mix_in`` and ``mix_out``; the scans; shared attention
   and its flash; the shared MLPs; the rest), with the SM clock and power
   that ``nvidia-smi`` samples through them; the same 8 x 3840 split by
   the plain route (no mix launch), and the scan and the hd-160 flash at
   8 x 3840 timed right after ``mix_out``'s kernel, after the plain
   ``mix_out`` passes and after a spin: the ``mamba2_mix_in`` and
   ``mamba2_mix_out`` records.  Phases 8 and 17 count their launches, one
   each a Mamba2 layer a prefill, and phase 14's olmoe and vlm prefills
   none.  ``python3 -c "import chip_smoke; chip_smoke.mamba2_mix_bench()"``
   runs it alone with its build.

The card's ``nvidia-smi`` line comes two lines before the end, then
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32, outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
F64_OPS_PER_S = 34e12         # H100 SXM float64 outside the tensor cores
MINRESID_RTOL = 1e-12         # admit_columns vs plain: the residents' sum
                              # order only (the reference tests' tolerance)
RTOL, ATOL = 1e-4, 1e-2       # kernel vs plain: reduction order only
ENGINE_RTOL = 1e-4            # fleet_engine vs plain_engine wastage
# kernel vs plain, (rtol, atol) by dtype: the reference tests' tolerances
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
SSD_TOL = {torch.float32: (5e-3, 5e-3), torch.bfloat16: (2e-2, 2e-2)}
WASTAGE = "src/repro_torch/kernels/wastage/csrc/wastage.cu"
SOURCES = {"oom_probe": WASTAGE, "wastage_eval": WASTAGE,
           "fleet_engine": WASTAGE,
           "ssd": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
           "flash_attention":
               "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu"}
SOURCES.update(ssd_bwd=SOURCES["ssd"],
               flash_attention_bwd=SOURCES["flash_attention"])
ADMISSION = "src/repro_torch/kernels/admission/csrc/admission.cu"
SOURCES.update(admit_columns=ADMISSION, admit_drain=ADMISSION)
SOURCES["decode_attention"] = ("src/repro_torch/kernels/decode_attention/"
                               "csrc/decode_attention.cu")
MAMBA2_MIX = "src/repro_torch/kernels/mamba2_mix/csrc/mamba2_mix.cu"
SOURCES.update(mamba2_mix_in=MAMBA2_MIX, mamba2_mix_out=MAMBA2_MIX)
# The backward kernels have no Pallas counterpart: the reference trains
# through the XLA forms of the two layers and JAX's autodiff of them.
REPLACES = {"oom_probe": "src/repro/kernels/wastage/kernel.py:67",
            # every attempt of the reference engine's while_loop, each
            # attempt the oom_probe kernel's work
            "fleet_engine": "src/repro/kernels/wastage/kernel.py:67",
            "wastage_eval": "src/repro/kernels/wastage/kernel.py:27",
            "ssd": "src/repro/kernels/ssd/kernel.py:28",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:33",
            "ssd_bwd": "src/repro/models/mamba2.py:30",
            "flash_attention_bwd": "src/repro/models/attention.py:92",
            # the reference's jitted admission programs (XLA, not Pallas)
            "admit_columns": "src/repro/sched/admission.py:100",
            "admit_drain": "src/repro/sched/admission.py:166",
            # no TPU kernel: the reference's decode is a plain einsum
            "decode_attention": "none (src/repro/models/attention.py:146)",
            # no TPU kernel: the reference's mixer is plain XLA
            "mamba2_mix_in": "none (src/repro/models/mamba2.py:133)",
            "mamba2_mix_out": "none (src/repro/models/mamba2.py:133)"}
KW = dict(seed=0, train_frac=0.5, k=4, machine_memory=128.0)  # the cells
ARCH = "zamba2-2.7b"
SERVE_BATCHES = ((4, 2048), (3, 1000))  # (requests, prompt tokens)
NEW_TOKENS = 32
WARM_RUNS = 5   # phase 15's step time: the median of this many warm calls


def tensor_bytes(*objs) -> int:
    """Bytes of the distinct storages of the tensors in ``objs`` (modules,
    dicts, lists and tensors, nested; a DTensor's local shard)."""
    seen = {}

    from torch.distributed.tensor import DTensor

    def walk(o):
        if isinstance(o, DTensor):
            walk(o.to_local())
        elif isinstance(o, torch.Tensor):
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(o, torch.nn.Module):
            for t in o.parameters():
                walk(t)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
    for o in objs:
        walk(o)
    return sum(seen.values())


def step_memory(before, args_bytes):
    """The card's memory record of one step: ``max_memory_allocated``
    since the reset, the allocation at the step's start, the bytes of the
    step's own arguments (parameters, optimizer state, inputs) and the
    step's peak, ``max_allocated - before + args``: the arguments and what
    the step allocated, without what else the process held."""
    peak = torch.cuda.max_memory_allocated()
    return {"max_allocated_bytes": peak, "allocated_before_bytes": before,
            "args_bytes": args_bytes,
            "step_peak_bytes": peak - before + args_bytes}


def log(*a):
    print(*a, flush=True)


CARD_TESTS = [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
              "-p", "no:cacheprovider", "tests/"]


def card_tests():
    """Phase 3: the ``cuda``-marked tests in a process of their own, from
    the checkout's root (they load the libraries phase 2 built).  Raises,
    after printing the end of pytest's output, if any test fails or skips:
    on the card every one of them runs.  Returns the seconds and pytest's
    summary line."""
    t0 = time.perf_counter()
    r = subprocess.run(CARD_TESTS, cwd=ROOT, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    if r.returncode != 0 or "skipped" in summary or "passed" not in summary:
        print(r.stdout[-12000:], r.stderr[-4000:], sep="\n", flush=True)
        raise AssertionError(f"the card tests: exit {r.returncode}, "
                             f"{summary!r}")
    return secs, summary


# ------------------------------------------------------------- phases 4-6
class ShapeRecorder:
    """While active, records ``key(*args, **kwargs)`` of every call of
    ``module.name`` (its callers look the wrapper up in the module at each
    call).  It only records: launches and their counts stay the wrapper's
    own."""

    def __init__(self, module, name, key):
        self.module, self.name, self.key, self.seen = module, name, key, set()

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def recorded(*args, **kwargs):
            self.seen.add(self.key(*args, **kwargs))
            return orig(*args, **kwargs)
        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class FleetCalls:
    """While active, times every ``simulate_fleet_many`` call of the main
    path on the host clock, each ending in a synchronise: the fit's (by
    ``KSPlusAuto`` through ``core.fleet.simulate_fleet``) and the replay's
    (``sched.simulator`` binds its own name).  ``calls`` holds ``(stage,
    seconds, lanes)`` per call; it only records."""

    def __init__(self):
        from repro_torch.core import fleet
        from repro_torch.sched import simulator
        self.targets = ((fleet, "fit"), (simulator, "replay"))
        self.calls = []

    def __enter__(self):
        self.orig = [(mod, mod.simulate_fleet_many) for mod, _ in
                     self.targets]
        for (mod, stage), (_, orig) in zip(self.targets, self.orig):
            def timed(jobs, mems, *args, _orig=orig, _stage=stage, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(jobs, mems, *args, **kw)
                torch.cuda.synchronize()
                self.calls.append((_stage, time.perf_counter() - t0,
                                   sum(len(r.attempts) for r in out)))
                return out
            mod.simulate_fleet_many = timed
        return self

    def __exit__(self, *exc):
        for mod, orig in self.orig:
            mod.simulate_fleet_many = orig

    def split(self):
        out = {}
        for stage, secs, lanes in self.calls:
            s = out.setdefault(stage, {"calls": 0, "seconds": 0.0,
                                       "lanes": 0})
            s["calls"] += 1
            s["seconds"] += secs
            s["lanes"] += lanes
        return out


def fleet_scale(recorders=()):
    """Phase 5: sarek with 2000 executions per family on the card: stage
    seconds, wall, launches, and the fit's and the replay's fleet calls
    timed apart (:class:`FleetCalls`).  ``recorders`` are entered around
    the run."""
    import contextlib

    from repro_torch.kernels.wastage import ops
    from repro_torch.sched import evaluate_workflow
    from repro_torch.traces import sarek
    big = sarek(instances_per_family=2000)
    ops.reset_launches()
    with contextlib.ExitStack() as stack:
        for r in recorders:
            stack.enter_context(r)
        calls = stack.enter_context(FleetCalls())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_workflow(big, device="cuda", **KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = calls.split()
    fit_fleet = split.get("fit", {}).get("seconds", 0.0)
    return big, res, {"seconds": res.seconds, "wall": wall,
                      "launches": dict(ops.LAUNCHES), "fleet_calls": split,
                      "fit_fleet_share": fit_fleet / res.seconds["fit"]}


def device_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def fleet_split(runs=3):
    """Phase 5 ``runs`` times on whatever ``repro_torch`` is importable, one
    JSON line each: with an earlier commit's ``src`` first on ``sys.path``
    it measures that commit's engine, e.g. ``python3 -c "import sys;
    sys.path.insert(0, 'build/parent/src'); import chip_smoke;
    chip_smoke.fleet_split()"`` from a ``git archive`` of the parent
    unpacked under ``build/parent``."""
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels.wastage import ops
    smi = device_line()
    build.build(ops.SOURCE)  # run 0 still pays the process's first calls
    for i in range(runs):
        _, _, rec = fleet_scale()
        rec.update(run=i, package=os.path.dirname(repro_torch.__file__),
                   device=smi)
        log(json.dumps(rec))


def engine_tables(ops):
    """Records ``(table, machine_memory, dt, max_attempts)`` of every
    ``fleet_engine`` call (``core.fleet`` looks the wrapper up in the module
    at each call); the tables keep their tensors alive for phase 6."""
    return ShapeRecorder(ops, "fleet_engine", lambda *args: args)


def check_engine(calls, err):
    """``fleet_engine`` against the plain engine on the same CUDA table:
    attempts and successes exact, wastage within rtol 1e-4 (the reference
    test_fleet's tolerance: the retried lanes' trace sums are reduced in
    another order)."""
    from repro_torch.kernels.wastage import ops
    from repro_torch.kernels.wastage.ref import plain_engine
    lanes = 0
    for name, table, mm, dt, max_attempts in calls:
        got = ops.fleet_engine(table, mm, dt, max_attempts).cpu().numpy()
        want = plain_engine(table, mm, dt, max_attempts).numpy()
        for row, what in ((1, "attempts"), (2, "successes")):
            bad = np.nonzero(got[row] != want[row])[0]
            if bad.size:
                raise AssertionError(
                    f"fleet_engine {what} differ on {name} at lanes "
                    f"{bad[:8].tolist()}: {got[row][bad[:8]].tolist()} vs "
                    f"{want[row][bad[:8]].tolist()}")
        gw, ww = got[0].view(np.float32), want[0].view(np.float32)
        np.testing.assert_allclose(gw, ww, rtol=ENGINE_RTOL,
                                   err_msg=f"fleet_engine wastage on {name}")
        err["fleet_engine"] = max(err.get("fleet_engine", 0.0), float(
            np.abs(gw.astype(np.float64) - ww).max(initial=0.0)))
        lanes += table.n_lanes
    return lanes


def describe(table):
    """``n_lanes, [(B, K, T) per group]`` of a group table."""
    return table.n_lanes, [(g.B, g.K, int(g.mems.shape[1]))
                           for g in table.groups]


# ------------------------------------------------------------------ timing
def time_ms(fn, reps=25, warmup=3):
    """Median device ms of ``fn`` per call (CUDA events).

    Before each timed call the 50 MB L2 is flushed (the main path meets each
    bucket cold) and the device is kept busy with a sleep while the host
    enqueues the call, so the events bracket device time, not the Python
    wrapper's launch latency.
    """
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def probe_table(res, wf, seed, train_frac):
    """The attempt-1 probe of the ks+ job as one group table: the test
    split bucketed on the card, the plans sliced per bucket, the longest
    bucket first."""
    from repro_torch.core.fleet import (bucket_traces, concat_packed,
                                        packed_predict)
    from repro_torch.kernels.wastage import ops
    _, test = wf.split(seed, train_frac, 1.0)
    fams = [f for f in wf.families if test[f]]
    flat = [e for f in fams for e in test[f]]
    traces = bucket_traces([e.mem for e in flat], device="cuda")
    starts, peaks, _ = concat_packed([
        packed_predict(res.fitted[f]["ks+"], [e.input_gb for e in test[f]])
        for f in fams])
    return ops.GroupTable([ops.Group(starts[b.idx], peaks[b.idx], b.dmems,
                                     b.dlengths)
                           for b in reversed(traces.buckets)], "cuda")


def check_grouped(table, dt, err):
    """The grouped probes against the plain versions group by group."""
    from repro_torch.kernels.wastage import ops, ref
    viol, ws, wk = ops.oom_probe_groups(table, dt)
    we = ops.wastage_eval_groups(table, dt)
    for g, lo in zip(table.groups, table.lane0[:-1]):
        hi = lo + g.B
        vr, wsr, wkr = ref.oom_probe(g.starts, g.peaks, g.mems[:g.B],
                                     g.lengths[:g.B], dt)
        wer = ref.wastage_eval(g.starts, g.peaks, g.mems[:g.B],
                               g.lengths[:g.B], dt)
        if not torch.equal(viol[lo:hi], vr):
            raise AssertionError(f"grouped oom_probe viol differs at group "
                                 f"{(g.B, g.K, int(g.mems.shape[1]))}")
        for op, a, b in (("oom_probe", ws[lo:hi], wsr),
                         ("oom_probe", wk[lo:hi], wkr),
                         ("wastage_eval", we[lo:hi], wer)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                       msg=f"grouped {op}")
            err[op] = max(err.get(op, 0.0), float((a - b).abs().max()))


def table_bytes(table, out_bytes, engine=False):
    """Bytes the function of a launch over ``table`` must move, fixed by
    the shapes: each row's valid samples and length once (the jobs of an
    engine call share their buckets, so a bucket counts once), each lane's
    plan once (for the engine also its segment count and bump), and
    ``out_bytes`` of outputs a lane once."""
    rows, nbytes = {}, 0
    for g in table.groups:
        rows[(g.mems.data_ptr(), g.B)] = (int(g.lengths[:g.B].sum()), g.B)
        per_lane = 2 * g.K * 4 + out_bytes
        if engine:
            per_lane += 4 + (4 if g.bump_lanes is not None else 0)
        nbytes += g.B * per_lane
    valid = sum(v for v, _ in rows.values())
    lanes = sum(b for _, b in rows.values())
    nbytes += valid * 4 + lanes * 4
    return nbytes, valid


def kernel_timings(table, engine_call, launches, err):
    """The wastage kernels at phase 5's shapes, one launch each: both
    probes over the ks+ job's attempt-1 groups, the engine over the
    replay's group table; each beside its plain version and its bound."""
    from repro_torch.kernels.wastage import ops, ref

    def plain_probe(fn):
        return lambda: [fn(g.starts, g.peaks, g.mems[:g.B], g.lengths[:g.B],
                           1.0) for g in table.groups]
    shapes = describe(table)[1]
    out = []
    # outputs a lane: viol, w_succ, w_kill; w_succ
    for name, out_bytes, kern, plain in (
            ("oom_probe", 12, ops.oom_probe_groups, ref.oom_probe),
            ("wastage_eval", 4, ops.wastage_eval_groups, ref.wastage_eval)):
        nbytes, valid = table_bytes(table, out_bytes)
        # per valid sample: the slot walk's compare, max, subtract, add
        # and the violation compare; O(K) per lane besides
        out.append(_entry(
            name, launches, err, time_ms(lambda: kern(table, 1.0)),
            time_ms(plain_probe(plain)), None, nbytes, valid * 5,
            "attempt-1 probe of the ks+ job over the fleet-scale test split:"
            " one launch over its length buckets", F32_OPS_PER_S,
            groups=shapes))
    etable, mm, dt, max_attempts = engine_call
    # outputs a lane: wastage (float32), attempts (int32), succeeded (bool)
    nbytes, valid = table_bytes(etable, 4 + 4 + 1, engine=True)
    buckets = len({g.mems.data_ptr() for g in etable.groups})
    jobs = len(etable.groups) // buckets
    # per valid sample of each job's lanes at least one compare
    out.append(_entry(
        "fleet_engine", launches, err,
        time_ms(lambda: ops.fleet_engine(etable, mm, dt, max_attempts)),
        time_ms(lambda: ref.plain_engine(etable, mm, dt, max_attempts)),
        None,
        nbytes, valid * jobs,
        "the sarek(2000) replay's fleet call: every attempt of "
        f"{etable.n_lanes} lanes ({jobs} jobs x {buckets} buckets) in one "
        "launch; the plain engine's time includes its two host reads",
        F32_OPS_PER_S, groups=describe(etable)[1]))
    return out


def wastage_timings(res, big, recorded, launches, err):
    """Phase 6's kernel times: the probes over phase 5's attempt-1 groups
    of the ks+ job (checked first), the engine over the replay's table,
    the largest of the ``recorded`` engine calls."""
    probes = probe_table(res, big, 0, 0.5)
    check_grouped(probes, 1.0, err)
    replay = max(recorded, key=lambda c: c[0].n_lanes)
    return kernel_timings(probes, replay, launches, err)


def kernel_bench():
    """Phase 5 once, then phase 6's checks and kernel times
    (:func:`check_engine`, :func:`wastage_timings`) on whatever
    ``repro_torch`` is importable; one JSON line.  With an earlier tree's
    ``src`` first on ``sys.path`` (see :func:`fleet_split`) it times that
    tree's kernels in the same call."""
    import repro_torch
    from repro_torch.kernels.wastage import ops
    tables = engine_tables(ops)
    big, res, rec = fleet_scale(recorders=(tables,))
    err = {}
    check_engine([("main path", *c) for c in tables.seen], err)
    kernels = wastage_timings(res, big, tables.seen, rec["launches"], err)
    log(json.dumps({
        "package": os.path.dirname(repro_torch.__file__),
        "device": device_line(), "phase5": rec,
        "kernels": [{k: e[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                       "max_abs_err")} for e in kernels]}))


# ------------------------------------------------------------------ phase 4
def compare_runs(card, cpu, label):
    for m in card.methods:
        a, b = card.methods[m], cpu.methods[m]
        if (a.retries, a.failures) != (b.retries, b.failures):
            raise AssertionError(
                f"{label}/{m}: card retries/failures {a.retries}/{a.failures}"
                f" vs cpu {b.retries}/{b.failures}")
        np.testing.assert_allclose(a.total_gbs, b.total_gbs, rtol=1e-4,
                                   err_msg=f"{label}/{m}")
        for fam in a.per_family_gbs:
            np.testing.assert_allclose(
                a.per_family_gbs[fam], b.per_family_gbs[fam], rtol=1e-4,
                atol=1e-2, err_msg=f"{label}/{m}/{fam}")
        if not all(math.isfinite(v) for v in a.per_family_gbs.values()):
            raise AssertionError(f"{label}/{m}: non-finite wastage")
    for fam in card.fitted:
        ka = card.fitted[fam]["ks+auto"].chosen_k
        kb = cpu.fitted[fam]["ks+auto"].chosen_k
        if ka != kb:
            raise AssertionError(f"{label}/{fam}: chosen k {ka} vs {kb}")


# ------------------------------------------------------------- phase 10
def _close(got, want, tol, what, err, name):
    """Hold a kernel output against its plain version; fold the largest
    absolute error into ``err[name]``."""
    rtol, atol = tol
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{what}: {m}")
    err[name] = max(err.get(name, 0.0), float((got.float() - want.float())
                                     .abs().max()))


def flash_case(rng, B, Sq, Skv, H, K, hd, dtype, causal=True, window=None):
    f = lambda *sz: torch.as_tensor(  # noqa: E731
        rng.standard_normal(sz), dtype=torch.float32).to("cuda", dtype)
    return (f(B, Sq, H, hd), f(B, Skv, K, hd), f(B, Skv, K, hd), causal,
            window)


def ssd_case(rng, B, S, H, P, G, N, chunk, dtype):
    f = lambda a: torch.as_tensor(  # noqa: E731
        a, dtype=torch.float32).to("cuda", dtype)
    return (f(rng.standard_normal((B, S, H, P)) * 0.5),
            f(-np.abs(rng.standard_normal((B, S, H))) * 0.3),
            f(rng.standard_normal((B, S, G, N)) * 0.5),
            f(rng.standard_normal((B, S, G, N)) * 0.5), chunk)


def check_lm_kernels(flash, ssd, err):
    """Hold both LM kernels against their plain versions on the cases."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    for name, (q, k, v, causal, window) in flash:
        got = fops.flash_attention(q, k, v, causal=causal, window=window)
        want = fops.ref.flash_attention(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        _close(got, want, FLASH_TOL[q.dtype], f"flash_attention {name}",
               err, "flash_attention")
    for name, (X, A, Bm, Cm, chunk) in ssd:
        y, st = sops.ssd(X, A, Bm, Cm, chunk)
        yr, sr = sops.ref.ssd(X, A, Bm, Cm, chunk)
        torch.cuda.synchronize()
        _close(y, yr, SSD_TOL[X.dtype], f"ssd y {name}", err, "ssd")
        _close(st, sr, SSD_TOL[torch.float32], f"ssd state {name}", err,
               "ssd")


def lm_recorders():
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    return (ShapeRecorder(sops, "ssd", lambda X, A, Bm, Cm, chunk: (
                *X.shape, *Bm.shape[2:], chunk, X.dtype)),
            ShapeRecorder(fops, "flash_attention", lambda q, k, v, **kw: (
                q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], kw.get("causal"), kw.get("window"), q.dtype)))


def phase_shape_cases(ssd_shapes, flash_shapes):
    """Seeded inputs at every shape the serving phase launched."""
    rng = np.random.default_rng(1)
    flash = [(f"serving {s}", flash_case(rng, *s[:6], s[8], s[6], s[7]))
             for s in sorted(flash_shapes, key=str)]
    ssd = [(f"serving {s}", ssd_case(rng, *s))
           for s in sorted(ssd_shapes, key=str)]
    return flash, ssd


# ------------------------------------------------------------- phase 7
def _short(mangled):
    """``_ZN3fa314flash_fwd_bf16ILi80EEEv...`` -> ``flash_fwd_bf16<80>``;
    type arguments by name (``scores_kernel<__nv_bfloat16,1,1>``)."""
    rest, name = mangled[3:], mangled
    while rest[:1].isdigit():  # <length><identifier> pairs of the nesting
        n = re.match(r"\d+", rest).group()
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    if rest.startswith("I"):
        rest, args = rest[1:], []
        while rest and rest[0] != "E":
            m = re.match(r"L[ib](-?\d+)E", rest)
            if m:
                args.append(m.group(1))
            elif rest[0] == "f":
                m = re.match("f", rest)
                args.append("float")
            elif rest[0].isdigit():
                n = re.match(r"\d+", rest).group()
                m = re.match(rf"\d+\w{{{n}}}", rest)
                args.append(m.group()[len(n):])
            else:
                break
            rest = rest[m.end():]
        if args and rest[:1] == "E":
            name += "<" + ",".join(args) + ">"
    return name


def kernel_report(source, path, keep=lambda name: "bf16" in name
                  or "ssd3" in name):
    """Per kernel of ``source`` whose mangled name ``keep`` accepts (by
    default the bf16 LM kernels): registers, spill bytes and any
    performance advisory (wgmma serialisation) from the build's ``ptxas``
    output, ``HGMMA`` instructions from ``cuobjdump -sass`` (left out where
    the toolkit has no ``cuobjdump``)."""
    from repro_torch.kernels import build
    report, fn = {}, None
    for line in build.build_log(source).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if "Performance Loss" in line:  # ptxas advisories on wgmma
            advised = re.search(r"'?(_Z\w+)", line)
            key = advised.group(1) if advised else fn
            report.setdefault(key, {}).setdefault("advisory", []).append(
                line.split("Potential")[-1].strip()[:160])
        elif m:
            fn = m.group(1)
            report.setdefault(fn, {})
        elif fn and "spill stores" in line:
            report[fn]["spills"] = [int(x) for x in re.findall(
                r"(\d+) bytes spill", line)]
        elif fn and "Used" in line and "registers" in line:
            report[fn]["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True,
                          check=True).stdout if os.path.exists(
                              cuobjdump) else None
    if sass is not None:
        for block in sass.split("Function : ")[1:]:
            name = block.split()[0]
            if name in report:
                report[name]["HGMMA"] = block.count("HGMMA")
    return {_short(k): v for k, v in report.items() if keep(k)}


# ------------------------------------------------------------- phase 8
def serve(model, cfg, batches, new_tokens, seed, feed=None):
    """``serve_demo``'s loop (``launch/serve.py``) on the card: per batch a
    prefill, then greedy decode steps.  ``feed(rng, Bsz, S)`` gives the
    prefill batch in place of the tokens (a vlm's embeds and positions;
    its decode steps are then fed zero embeds, as ``serve_demo``'s).  An
    MoE model's record holds each layer's ``moe_dropped_frac`` of the
    prefill (a forward hook on each block; decode calls ``decode``).
    Returns one record per batch."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.runtime import make_decode_step, make_prefill_step
    rng = np.random.default_rng(seed)
    decode = make_decode_step(cfg)
    dropped = []
    hooks = [blk.register_forward_hook(
        lambda mod, args, out: dropped.append(out[2]["moe_dropped_frac"]))
        for blk in model.blocks] if cfg.family == "moe" else []
    out = []
    for Bsz, S in batches:
        prefill = make_prefill_step(cfg, capacity=S + new_tokens)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (Bsz, S)),
                               dtype=torch.int32, device="cuda")
        batch = {"tokens": toks} if feed is None else feed(rng, Bsz, S)
        dropped.clear()
        before = (sops.LAUNCHES["ssd"], fops.LAUNCHES["flash_attention"])
        mix_before = dict(mops.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_memory = step_memory(allocated, tensor_bytes(model, batch))
        launched = (sops.LAUNCHES["ssd"] - before[0],
                    fops.LAUNCHES["flash_attention"] - before[1])
        mix_launched = {k: v - mix_before[k]
                        for k, v in mops.LAUNCHES.items()}
        finite = torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1)
        zeros = torch.zeros((Bsz, 1, cfg.d_model), device="cuda")
        decode_before = dops.LAUNCHES["decode_attention"]
        for t in range(new_tokens):
            pos = torch.full((Bsz,), S + t, dtype=torch.int32, device="cuda")
            db = {"tokens": tok} if feed is None else {"embeds": zeros}
            logits, cache = decode(model, db, cache, pos)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        decode_launches = (sops.LAUNCHES["ssd"] - before[0] - launched[0],
                           fops.LAUNCHES["flash_attention"] - before[1]
                           - launched[1])
        out.append({"requests": Bsz, "prompt": S, "new_tokens": new_tokens,
                    "prefill_s": t1 - t0, "decode_s": t2 - t1,
                    "decode_tok_per_s": Bsz * new_tokens / (t2 - t1),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "prefill_launches": {"ssd": launched[0],
                                         "flash_attention": launched[1]},
                    "decode_launches": {"ssd": decode_launches[0],
                                        "flash_attention":
                                            decode_launches[1]},
                    "decode_attention_launches":
                        dops.LAUNCHES["decode_attention"] - decode_before,
                    "mix_launches": mix_launched,
                    "finite": bool(finite), "last_tokens": tok.tolist(),
                    "prefill_memory": prefill_memory})
        if dropped:
            out[-1]["moe_dropped_frac"] = [float(d) for d in dropped]
        del cache, logits
    for h in hooks:
        h.remove()
    return out


def warm_prefill(model, cfg, Bsz, S, feed=None, seed=0, runs=WARM_RUNS):
    """``runs`` timed prefills of one ``Bsz`` x ``S`` batch after an untimed
    one at that shape, each ending in a synchronise: the step time phase 15
    holds the dry run's bound against (a first call at a new shape also
    pays the allocator's growth).  Called after a phase has read its
    launch counts."""
    from repro_torch.runtime import make_prefill_step
    prefill = make_prefill_step(cfg, capacity=S + NEW_TOKENS)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (Bsz, S)),
                                       dtype=torch.int32, device="cuda")} \
        if feed is None else feed(rng, Bsz, S)
    secs = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(model, batch)
        torch.cuda.synchronize()
        if i:
            secs.append(time.perf_counter() - t0)
        del out
    return {"requests": Bsz, "prompt": S, "runs_s": secs,
            "median_s": float(np.median(secs))}


# Device kernels by kind, the first match in order, else "other": the
# port's own kernels by their entry points' names, then cuBLAS's products
# and the MoE dispatch and combine (the stable sort of the expert ids, the
# token gathers, the buffer scatter and the permutation's inverse).
KINDS = {"ssd_bwd": ("ssd_bwd_",),
         "ssd": ("ssd_states", "ssd_pass", "ssd_scan"),
         "flash_attention_bwd": ("flash_bwd_",),
         "flash_attention": ("flash_fwd",),
         "decode_attention": ("dattn::",),
         "mamba2_mix": ("m2mix::",),
         "matmul": ("gemm", "xmma", "cutlass", "nvjet", "cublas"),
         "sort_gather_scatter": ("Sort", "sort", "Radix", "radix", "index",
                                 "Index", "gather", "Gather", "scatter",
                                 "Scatter")}
PORT_KINDS = ("ssd_bwd", "ssd", "flash_attention_bwd", "flash_attention",
              "decode_attention", "mamba2_mix")


def profile_call(fn):
    """``fn()`` once under the benchmark's tracer (``perfbench.trace``: the
    card's operations from ``torch.profiler``).  Returns what ``fn``
    returned and the record: wall ms; device busy ms, the union of the
    operations' intervals (``busy_s``, as the benchmark reads its idle
    share), idle share and the count of device operations; device ms by
    kind (:data:`KINDS`); the top
    kernels (ms, launches, name); and ms and launches of every kernel of
    the port's kinds."""
    from perfbench.trace import Tracer, busy_s
    tracer = Tracer()
    tracer.start()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = tracer.stop()
    by_name = {}
    for name, start, end, _ in events:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
    by_kind, port = {}, {}
    for name, (ms, n) in by_name.items():
        kind = next((k for k, keys in KINDS.items()
                     if any(x in name for x in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        if kind in PORT_KINDS:
            port[name.removeprefix("void ").split("(")[0]] = (ms, n)
    top = sorted(((ms, n, name[:90]) for name, (ms, n) in by_name.items()),
                 reverse=True)
    busy = busy_s(events) * 1e3
    return result, {"wall_ms": wall_ms, "device_busy_ms": busy,
                    "idle_share": 1 - busy / wall_ms,
                    "device_ops": len(events),
                    "device_ms_by_kind": by_kind,
                    "top_kernels_ms_count": top[:15],
                    "port_kernels_ms_count": port}


def prefill_call(model, cfg, Bsz, S, seed=3):
    """One ``Bsz`` x ``S`` prefill of seeded tokens, to call."""
    from repro_torch.runtime import make_prefill_step
    prefill = make_prefill_step(cfg, capacity=S + NEW_TOKENS)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (Bsz, S)), dtype=torch.int32, device="cuda")
    return lambda: prefill(model, {"tokens": toks})


# ------------------------------------------------------------- phase 9
def card_and_cpu(cfg, seed):
    """The model of ``cfg`` drawn on the card from ``seed``, and its copy
    on the CPU."""
    from repro_torch.models import init_params
    card = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    cpu = init_params(cfg, None, device="cpu")
    cpu.load_state_dict(card.state_dict())
    return card, cpu


def serve_both(cfg, card, cpu, prompt, feeds, S, recorders=None):
    """prefill(``prompt``) + one decode step per entry of ``feeds`` (CPU
    batches), on the card and on the CPU.  Returns ``pairs`` of (name,
    card tensor on the host, CPU tensor) for every logits and cache entry;
    ``recorders`` (``{"cuda": ..., "cpu": ...}``) are entered around each
    side's run."""
    import contextlib

    from repro_torch.models import decode_step, prefill
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        with recorders[dev] if recorders else contextlib.nullcontext():
            logits, cache = prefill(
                model, cfg, {k: v.to(dev) for k, v in prompt.items()},
                capacity=S + len(feeds))
            outs = [logits]
            for t, feed in enumerate(feeds):
                pos = torch.full((1,), S + t, dtype=torch.int32, device=dev)
                logits, cache = decode_step(
                    model, cfg, {k: v.to(dev) for k, v in feed.items()},
                    cache, pos)
                outs.append(logits)
        runs[dev] = (outs, cache)
    pairs = [(f"logits {i}", a.cpu(), b) for i, (a, b) in
             enumerate(zip(runs["cuda"][0], runs["cpu"][0]))]
    for k, b in runs["cpu"][1].items():
        a = runs["cuda"][1][k].cpu()
        if k == "kv_positions":
            if not torch.equal(a, b):
                raise AssertionError(f"{cfg.name} kv_positions differ")
            continue
        pairs.append((f"cache {k}", a.float(), b.float()))
    return pairs


def card_vs_cpu(dtype_name, seed=1, S=300, steps=4):
    """Full width, 6 Mamba2 blocks + the shared block: the card's prefill
    and decode against the plain path on the CPU, same weights and tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCH), n_layers=6, dtype=dtype_name)
    card, cpu = card_and_cpu(cfg, seed)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                           dtype=torch.int32)
    feeds = torch.as_tensor(rng.integers(0, cfg.vocab, (steps, 1)),
                            dtype=torch.int32)
    pairs = serve_both(cfg, card, cpu, {"tokens": toks},
                       [{"tokens": f} for f in feeds], S)
    return hold_pairs(pairs, dtype_name)


def hold_pairs(pairs, dtype_name):
    """Phase 9's rule on (name, card, CPU) pairs; returns per name (max
    abs diff, max abs value, relative L2)."""
    worst = {}
    for what, a, b in pairs:
        scale = float(b.abs().max())
        if dtype_name == "float32":
            # never looser than 1e-3, and tighter for small tensors (the
            # SSM states are ~1e-4 at this init)
            rtol, atol = 1e-3, 1e-3 * min(1.0, scale)
        else:
            # bf16: 3e-2 of the element and of the tensor's largest value.
            # cuBLAS and the CPU round differently, one bf16 ulp here and
            # there through a bf16 residual stream, which leaves a few
            # tenths of a percent of full-width logits beyond an absolute
            # 3e-2 while float32 agrees to ~2e-5.
            rtol, atol = 3e-2, 3e-2 * scale
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{dtype_name} {what}: {m}")
        diff = float((a - b).abs().max())
        rel = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b).clamp_min(1e-30))
        worst[what] = (diff, scale, rel)
    return worst


# ------------------------------------------------------------- phase 10
def lm_kernel_timings(launches, err):
    """Both LM kernels at the 4 x 2048 serving shapes, bf16, beside their
    plain versions, their bounds and (attention) the library call."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    cfg = get_config(ARCH)
    Bsz, S = SERVE_BATCHES[0]
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    out = []

    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v, _, _ = flash_case(rng, Bsz, S, S, H, K, hd, bf)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(lambda: fops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fops.ref.flash_attention(q, k, v,
                                                        causal=True))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    # each input read once, the output written once; q.k and p.v over the
    # causal pairs only (the kernel skips tiles above the frontier): the
    # operator's FLOP rule, which the dry run counts
    nbytes = fops.io_bytes(Bsz, S, S, H, K, hd, 2)
    nops = fops.flops(Bsz, S, S, H, hd, True, None)
    out.append(_entry("flash_attention", launches, err, ms, plain_ms,
                      lib_ms, nbytes, nops,
                      f"causal prefill, q/k/v ({Bsz}, {S}, {H}, {hd}) bf16",
                      shape=dict(B=Bsz, Sq=S, Skv=S, H=H, K=K, hd=hd,
                                 causal=True, window=None)))

    Hs, P, G, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups, \
        cfg.ssm_state
    X, A, Bm, Cm, chunk = ssd_case(rng, Bsz, S, Hs, P, G, N,
                                      cfg.ssm_chunk, bf)
    ms = time_ms(lambda: sops.ssd(X, A, Bm, Cm, chunk))
    plain_ms = time_ms(lambda: sops.ref.ssd(X, A, Bm, Cm, chunk))
    # x, a, B, C read once; y (bf16) and the f32 final state written once;
    # per 64-row sub-chunk of each head (the fixed form: the bound may not
    # move with the kernel's tiling): C.B and G.x over the lower triangle,
    # C.state and the state update in full, the operator's FLOP rule.  The
    # bf16 kernel's scratch (chunk states, entering states, cumsums) counts
    # against its time, not the bound.
    nbytes = sops.io_bytes(Bsz, S, Hs, P, G, N, 2)
    nops = sops.flops(Bsz, S, Hs, P, N)
    out.append(_entry("ssd", launches, err, ms, plain_ms, None, nbytes,
                      nops, f"prefill scan, x ({Bsz}, {S}, {Hs}, {P}), "
                            f"G={G} N={N} bf16",
                      shape=dict(B=Bsz, S=S, H=Hs, P=P, G=G, N=N)))
    return out


def _bound(nbytes, nops, ops_per_s=BF16_OPS_PER_S):
    """``(ms, "bytes" or "operations")``: the larger of ``nbytes`` at the
    HBM rate and ``nops`` at ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _entry(name, launches, err, ms, plain_ms, lib_ms, nbytes, nops, timed,
           ops_per_s=BF16_OPS_PER_S, **extra):
    """One kernel's record of the ``{"kernels": ...}`` line: its bound is
    the larger of its bytes at the HBM rate and its operations at
    ``ops_per_s``."""
    bound_ms, bound_by = _bound(nbytes, nops, ops_per_s)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err.get(name), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "bytes": nbytes, "ops": nops,
            "timed": timed, **extra}


def check_launches(launches, calls, what):
    """The main path's wastage launches: exactly one ``fleet_engine`` per
    fleet call on the card, no per-attempt probe."""
    n = sum(c["calls"] for c in calls.values()) if isinstance(calls, dict) \
        else len(calls.calls)
    if launches["fleet_engine"] != n or n <= 0:
        raise AssertionError(f"{what}: {launches['fleet_engine']} fleet_engine"
                             f" launches for {n} fleet calls on the card")
    if launches["oom_probe"] or launches["wastage_eval"]:
        raise AssertionError(f"{what}: the main path launched a probe kernel "
                             f"{launches}")


# ------------------------------------------------------------- phase 11
CLUSTER_NODES = ((0, 48.0), (1, 64.0), (2, 32.0), (3, 96.0))
REPLAY_TASKS = 8192     # the reference benchmark's full size
DIFF_TASKS = 400        # the engines' differential replay
SUITE_GRID = (("burst_arrival", "deep_chain", "wide_fanout"),
              ("none", "poisson"), ("storm", "churn", "rack"))
RESULT_FIELDS = ("placements", "retries", "unschedulable", "evictions",
                 "starved", "doomed", "finished", "makespan")


def _same_result(a, b, what, fields=RESULT_FIELDS):
    for f in fields:
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{what}: {f} differs")
    np.testing.assert_allclose(a.total_wastage_gbs, b.total_wastage_gbs,
                               rtol=1e-6, err_msg=what)


ADMIT_KEEP = 8       # drains (and refreshes) of the replay kept for checks


def on_device(operands, device):
    """Fresh contiguous copies of numpy or tensor operands on ``device``."""
    return tuple((x if isinstance(x, torch.Tensor)
                  else torch.as_tensor(np.asarray(x))).to(device)
                 .contiguous().clone() for x in operands)


def check_drain(operands, masked, select, err, device, what):
    """``admit_drain`` against ``plain_drain`` on fresh copies of
    ``operands`` on ``device``: the vector (count, iterations, lanes,
    nodes) and ``admit_t`` exact.  Returns the vector."""
    from repro_torch.kernels.admission import ops as aops
    from repro_torch.kernels.admission import ref as aref
    kern, plain = on_device(operands, device), on_device(operands, device)
    vec, _ = aops.admit_drain(*kern, masked, select)
    want = aref.plain_drain(*plain, masked, select)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(vec, want):
        raise AssertionError(f"admit_drain != plain_drain on {what} "
                             f"({select}, masked {masked})")
    if not torch.equal(kern[2], plain[2]):
        raise AssertionError(f"admit_drain's admit_t differs on {what}")
    return vec


def check_columns(operands, masked, err, device, what):
    """``admit_columns`` against ``plain_columns``: fits exact, minimum
    residuals within ``MINRESID_RTOL``."""
    from repro_torch.kernels.admission import ops as aops
    from repro_torch.kernels.admission import ref as aref
    kern, plain = on_device(operands, device), on_device(operands, device)
    got = aops.admit_columns(*kern, masked)
    want = aref.plain_columns(*plain, masked)
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"admit_columns fits differ on {what}")
    torch.testing.assert_close(got[1], want[1], rtol=MINRESID_RTOL, atol=0,
                               msg=f"admit_columns on {what}")
    err["admit_columns"] = max(err.get("admit_columns", 0.0),
                               float((got[1] - want[1]).abs().max()))


class AdmissionCalls:
    """While active, records the (N, Q, R) of every ``admit_drain`` and
    ``admit_columns`` call of the main path and keeps copies of the
    operands of the ``keep`` largest of each (by N * Q * R, copied before
    the call), for the checks and timings after the run.  It only
    records: the launches and their counts stay the wrappers' own."""

    NAMES = ("admit_drain", "admit_columns")

    def __init__(self, keep=ADMIT_KEEP):
        from repro_torch.kernels.admission import ops as aops
        self.aops, self.keep = aops, keep
        self.shapes = {n: [] for n in self.NAMES}
        self.kept = {n: [] for n in self.NAMES}

    def __enter__(self):
        self.orig = {n: getattr(self.aops, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(self.aops, n, self._recorded(n))
        return self

    def _recorded(self, name):
        orig, kept, shapes = self.orig[name], self.kept[name], \
            self.shapes[name]

        def recorded(*args):
            (N, R), Q = args[7].shape, args[9].shape[0]
            shapes.append((N, Q, R))
            size = N * Q * R
            if len(kept) < self.keep or size > kept[-1][0]:
                kept.append((size, tuple(x.clone() for x in args[:12]),
                             args[12:]))
                kept.sort(key=lambda e: -e[0])
                del kept[self.keep:]
            return orig(*args)
        return recorded

    def __exit__(self, *exc):
        for n in self.NAMES:
            setattr(self.aops, n, self.orig[n])

    def summary(self):
        out = {}
        for n in self.NAMES:
            sh = np.array(self.shapes[n] or [(0, 0, 0)])
            out[n] = {"calls": len(self.shapes[n]),
                      "max_q": int(sh[:, 1].max()),
                      "mean_q": float(sh[:, 1].mean()),
                      "max_r": int(sh[:, 2].max()),
                      "mean_r": float(sh[:, 2].mean())}
        return out


def admission_work(operands, masked, vec=None):
    """``(bytes, float64 operations)`` an admission call needs on these
    inputs: each distinct resident's plan and times, each queued lane's
    need and grid (and plan, for the drain), the node operands read once;
    the output written once.  Operations count the residual over the
    real residents and, for a drain (``vec`` given), its iterations'
    compares and the placed envelopes' subtraction."""
    (starts, _, _, _, _, grid, caps, run_idx, run_valid, q_idx, _,
     _) = operands
    K, G = starts.shape[1], grid.shape[1]
    N, Q = caps.numel(), q_idx.numel()
    real = run_valid != 0
    residents = int(run_idx[real].unique().numel())
    per_lane = (2 * K + 1 + int(masked)) * 8
    nbytes = (residents * per_lane + N * 8 + 2 * run_idx.numel() * 8
              + Q * (2 * G * 8 + 8) + 16)
    nops = int(real.sum()) * Q * G * (K + 2 + 3 * int(masked)) \
        + N * Q * G * 3
    if vec is None:
        return nbytes + 2 * N * Q * 8, nops
    count, iterations = int(vec[0]), int(vec[1])
    nbytes += Q * (2 * K + int(masked)) * 8 + (2 + 3 * Q) * 8
    nops += iterations * N * Q * G * 2 \
        + count * Q * G * (K + 3 + 3 * int(masked))
    return nbytes, nops


# the reference's admission benchmarks (benchmarks/run.py), driven through
# the port's AdmissionState with their sizes and seeds
SCRIPT_LANES = 10_000          # bench_admission: B
SCRIPT_EVENTS = (3, 12)        # its --full events, admissions an event
PROTOCOL_LANES = 64            # bench_drain's dispatch accounting
PROTOCOL_TIMES = (0.0, 10.0, 40.0, 90.0)


def _bench_lanes(rng, B, K, G, peak_hi, est):
    """``bench_admission`` / ``bench_drain``'s lane draw: ``(starts,
    peaks, need, grid)`` of ``B`` step plans over ``est``-long grids."""
    from repro_torch.core.envelope import PAD_START, alloc_at_packed
    starts = np.full((B, K), PAD_START)
    peaks = np.zeros((B, K))
    grid = np.linspace(0.0, est, G, axis=1)
    for i in range(B):
        k = int(rng.integers(1, K + 1))
        starts[i, :k] = np.sort(np.concatenate(
            [[0.0], rng.uniform(1, 60, k - 1)]))
        peaks[i, :k] = np.sort(rng.uniform(2, peak_hi, k))
        peaks[i, k:] = peaks[i, k - 1]
    return starts, peaks, alloc_at_packed(starts, peaks, grid), grid


def admission_script(device, backend="fused"):
    """``bench_admission``'s script, the per-event hot path of the fused
    ``ClusterSim`` engine: ``SCRIPT_LANES`` lanes (K = 4, G = 64,
    ``use_dur``) on four nodes of 48 / 64 / 32 / 96 GB, each loaded with 8
    residents at 0.0, a warm-up ``columns`` over the whole queue, then
    ``SCRIPT_EVENTS`` events 7 s apart: each advances the clock and admits
    greedily through ``columns`` (one refresh of the stale entries over
    the 9,968-deep queue) and ``place``.  Returns the placements, the
    admission stats and the seconds after the warm-up."""
    from repro_torch.sched.admission import AdmissionState
    caps, K, G, per_node = (48.0, 64.0, 32.0, 96.0), 4, 64, 8
    rng = np.random.default_rng(0)
    adm = AdmissionState(caps, K=K, G=G, backend=backend, use_dur=True,
                         device=device if backend == "fused" else None)
    est = rng.uniform(30, 120, SCRIPT_LANES)
    adm.add_lanes(*_bench_lanes(rng, SCRIPT_LANES, K, G, 12, est), dur=est)
    lane = 0
    for ni in range(len(caps)):
        for _ in range(per_node):
            adm.place(ni, lane, 0.0)
            lane += 1
    queue = list(range(lane, SCRIPT_LANES))
    adm.columns(0.0, queue)
    placements = []
    t0 = time.perf_counter()
    now = 0.0
    events, admits = SCRIPT_EVENTS
    for _ in range(events):
        now += 7.0
        adm.sync_now(now)
        for _ in range(admits):
            M = adm.columns(now, queue)
            anyfit = M.any(axis=0)
            if not anyfit.any():
                break
            col = int(np.argmax(anyfit))
            ni = int(np.argmax(M[:, col]))
            ji = queue[col]
            queue.remove(ji)
            adm.place(ni, ji, now)
            placements.append((now, ni, ji))
    return {"placements": placements, "stats": dict(adm.stats),
            "seconds": time.perf_counter() - t0}


def drain_protocol(device, backend="fused"):
    """``bench_drain``'s dispatch accounting: ``PROTOCOL_LANES`` lanes
    (K = 3, G = 16, durations 20-100 s) on four nodes of 48 / 64 / 32 / 96
    GB, drained at ``PROTOCOL_TIMES``, each drain's placements leaving the
    queue.  Returns each drain's placements and the admission stats."""
    from repro_torch.sched.admission import AdmissionState
    rng = np.random.default_rng(0)
    adm = AdmissionState((48.0, 64.0, 32.0, 96.0), K=3, G=16,
                         backend=backend,
                         device=device if backend == "fused" else None)
    lanes = _bench_lanes(rng, PROTOCOL_LANES, 3, 16, 20.0,
                         rng.uniform(30, 120, PROTOCOL_LANES))
    remaining = list(adm.add_lanes(
        *lanes, dur=rng.uniform(20.0, 100.0, PROTOCOL_LANES)))
    drains = []
    for now in PROTOCOL_TIMES:
        placed = adm.drain(now, remaining)
        drains.append(placed)
        done = {ji for ji, _ in placed}
        remaining = [ji for ji in remaining if ji not in done]
    return {"drains": drains, "stats": dict(adm.stats)}


def admission_entries(calls, launches, err):
    """The kernel line's two admission records.  Every kept call of the
    ``calls`` recorders (the replay's, ``bench_admission``'s script's and
    ``bench_drain``'s protocol's) is checked against its plain version;
    ``admit_drain`` is timed at the replay's kept drains and
    ``admit_columns`` at the script's kept refreshes, kernel and plain
    version on the same copies, beside the bound.  A record's numbers are
    its largest call's; every timed call is in its ``calls``."""
    from repro_torch.kernels.admission import ops as aops
    from repro_torch.kernels.admission import ref as aref
    dev = torch.device("cuda")
    replay, script, _ = calls
    for rec in calls:
        for name in AdmissionCalls.NAMES:
            for _, operands, rest in rec.kept[name]:
                (N, R), Q = operands[7].shape, operands[9].shape[0]
                what = f"the main path's {name} call N={N} Q={Q} R={R}"
                if name == "admit_drain":
                    check_drain(operands, *rest, err, dev, what)
                else:
                    check_columns(operands, *rest, err, dev, what)
    timed = {"admit_drain": (replay, aops.admit_drain, aref.plain_drain,
                             "the cluster replay"),
             "admit_columns": (script, aops.admit_columns,
                               aref.plain_columns,
                               "bench_admission's script")}
    entries = []
    for name, (rec, kern_fn, plain_fn, where) in timed.items():
        rows = []
        for _, operands, rest in rec.kept[name]:
            (N, R), Q = operands[7].shape, operands[9].shape[0]
            row = {"N": N, "Q": Q, "R": R}
            vec = None
            if name == "admit_drain":
                vec = aops.admit_drain(*on_device(operands, dev),
                                       *rest)[0].cpu()
                row.update(count=int(vec[0]), iterations=int(vec[1]))
            kern, plain = on_device(operands, dev), on_device(operands, dev)
            row["ms"] = time_ms(lambda: kern_fn(*kern, *rest))
            row["plain_ms"] = time_ms(lambda: plain_fn(*plain, *rest),
                                      reps=9)
            row["bytes"], row["ops"] = admission_work(operands, rest[0], vec)
            row["bound_ms"] = _bound(row["bytes"], row["ops"],
                                     F64_OPS_PER_S)[0]
            rows.append(row)
        if not rows:
            raise AssertionError(f"the main path made no {name} call")
        top = rows[0]
        entries.append(_entry(
            name, launches, err, top["ms"], top["plain_ms"], None,
            top["bytes"], top["ops"],
            f"the largest {name} call of {where} (N={top['N']}, "
            f"Q={top['Q']}, R={top['R']}), one launch",
            F64_OPS_PER_S, median_ms=float(np.median([r["ms"] for r in rows])),
            calls=rows))
    return entries


def cluster_replay(err, device="cuda"):
    """Phase 11 (see the module docstring) on ``device``; returns its
    record and the replay's probe tables ``{(table, dt), ...}`` for the
    kernel line.  (``device="cpu"`` with smaller sizes rehearses it.)"""
    from repro_torch.core import RetrySpec, ksplus_retry
    from repro_torch.kernels.admission import ops as aops
    from repro_torch.kernels.wastage import ops
    from repro_torch.sched import ClusterSim, Node, evaluate_workflow
    from repro_torch.workloads import (assert_release_order,
                                       load_workflow_trace, make_suite,
                                       run_suite, scenarios, trace_state)
    from repro_torch.workloads import suite as suite_mod

    def nodes(spec=CLUSTER_NODES):
        return [Node(n, c) for n, c in spec]

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def admission_launches(stats, what):
        """One ``admit_drain`` launch per drain program, and host reads =
        drains + column refreshes, on the card (none on the CPU)."""
        got = dict(aops.LAUNCHES)
        if dev.type != "cuda":
            if any(got.values()):
                raise AssertionError(f"{what}: CPU tensors launched {got}")
            return got
        if got["admit_drain"] != stats["drain_dispatches"] or \
                stats["host_reads"] != got["admit_drain"] \
                + got["admit_columns"]:
            raise AssertionError(
                f"{what}: {got} for {stats['drain_dispatches']} drain "
                f"programs and {stats['host_reads']} host reads")
        return got

    rec = {}
    times = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        wf = scenarios.get("workload_replay", n_tasks=REPLAY_TASKS, seed=1,
                           device=dev)
        sync()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:
            first = wf
    for a, b in zip(first.batch.buckets, wf.batch.buckets):
        if not (np.array_equal(a.idx, b.idx) and torch.equal(a.dmems, b.dmems)
                and torch.equal(a.dsummem, b.dsummem)):
            raise AssertionError("workload_replay: same seed, other traces")
    if not (np.array_equal(first.input_gb, wf.input_gb)
            and np.array_equal(first.lengths, wf.lengths)):
        raise AssertionError("workload_replay: same seed, other tasks")
    del first
    rec["synthesis_s"] = times
    rec["buckets"] = [list(b.dmems.shape) for b in wf.batch.buckets]
    rec["trace_bytes"] = sum(b.dmems.numel() * 4 + b.dlengths.numel() * 4
                             + b.dsummem.numel() * 4
                             for b in wf.batch.buckets)

    jobs = wf.to_jobs(under_frac=0.1, seed=1)
    dt_groups = len({job.dt for job in jobs})
    sim = ClusterSim(nodes(), engine="fused", device=dev)
    ops.reset_launches()
    aops.reset_launches()
    with ShapeRecorder(ops, "oom_probe_groups",
                       lambda table, dt=1.0: (table, dt)) as probes, \
            AdmissionCalls() as adm_calls:
        sync()
        t0 = time.perf_counter()
        res = sim.run(jobs, RetrySpec("ksplus"))
        sync()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    adm_launches = admission_launches(sim.stats, f"{len(jobs)}-task replay")
    assert_release_order(jobs, res.placements)
    if res.unschedulable != 0:
        raise AssertionError(f"replay: {res.unschedulable} unschedulable")
    # one launch per dt group on the card; a CPU table launches nothing
    want = dt_groups if dev.type == "cuda" else 0
    if launches != {"oom_probe": want, "wastage_eval": 0,
                    "fleet_engine": 0} \
            or sim.stats["probe_groups"] != dt_groups:
        raise AssertionError(f"replay launched {launches} for {dt_groups} "
                             f"dt groups")
    rec["replay"] = {"tasks": len(jobs), "wall_s": wall,
                     "placements": len(res.placements),
                     "retries": res.retries, "makespan": res.makespan,
                     "wastage_gbs": res.total_wastage_gbs,
                     "utilization": res.avg_utilization,
                     "dt_groups": dt_groups, "launches": launches,
                     "admission_launches": adm_launches,
                     "admission_calls": adm_calls.summary(), **sim.stats}
    # the node-sharded drain on a one-rank group over the card: the same
    # placements, one lane and two collectives a drain iteration
    jobs = wf.to_jobs(under_frac=0.1, seed=1)
    ssim = ClusterSim(nodes(), engine="fused", shard=1, device=dev)
    sync()
    t0 = time.perf_counter()
    sres = ssim.run(jobs, RetrySpec("ksplus"))
    sync()
    swall = time.perf_counter() - t0
    if sres.placements != res.placements:
        raise AssertionError(f"{len(jobs)} tasks: the shard=1 drain placed "
                             f"otherwise than the unsharded drain")
    rec["replay_shard1"] = {"tasks": len(jobs), "wall_s": swall,
                            "placements": len(sres.placements),
                            **ssim.stats}
    del wf, jobs

    # the reference's admission benchmarks: bench_admission's script (the
    # column refresh over a 10,000-lane queue) and bench_drain's protocol,
    # each on the card, then fused on the CPU and on the numpy backend
    aops.reset_launches()
    with AdmissionCalls() as script_calls:
        sync()
        script = admission_script(dev)
        sync()
    script["launches"] = admission_launches(script["stats"],
                                            "bench_admission's script")
    if dev.type == "cuda" and not script["launches"]["admit_columns"]:
        raise AssertionError("bench_admission's script refreshed no column")
    aops.reset_launches()
    with AdmissionCalls() as protocol_calls:
        protocol = drain_protocol(dev)
    protocol["launches"] = admission_launches(protocol["stats"],
                                              "bench_drain's protocol")
    st = protocol["stats"]
    if st["drain_dispatches"] != st["drains"]:
        raise AssertionError(f"bench_drain's protocol: {st}, not one "
                             f"program a drain")
    for backend in ("fused", "numpy"):
        other = admission_script("cpu", backend)
        script[f"{backend}_cpu_s"] = other["seconds"]
        if other["placements"] != script["placements"]:
            raise AssertionError(f"bench_admission's script: the card placed "
                                 f"otherwise than {backend} on the CPU")
        if drain_protocol("cpu", backend)["drains"] != protocol["drains"]:
            raise AssertionError(f"bench_drain's protocol: the card drained "
                                 f"otherwise than {backend} on the CPU")
    rec["bench_admission"] = {
        "lanes": SCRIPT_LANES, "events": SCRIPT_EVENTS,
        "placements": len(script["placements"]),
        "seconds": script["seconds"],
        "fused_cpu_s": script["fused_cpu_s"],
        "numpy_cpu_s": script["numpy_cpu_s"],
        "admission_launches": script["launches"],
        "admission_calls": script_calls.summary(), **script["stats"]}
    rec["bench_drain"] = {
        "lanes": PROTOCOL_LANES, "times": PROTOCOL_TIMES,
        "placed": [len(d) for d in protocol["drains"]],
        "dispatches_per_drain": st["drain_dispatches"] / st["drains"],
        "admission_launches": protocol["launches"],
        "admission_calls": protocol_calls.summary(), **st}

    small = scenarios.get("workload_replay", n_tasks=DIFF_TASKS, seed=0,
                          device=dev)
    carried = load_workflow_trace(trace_state(small), device="cpu")
    runs = {}
    for name, engine, device, wf_, retry, shard in (
            ("fused", "fused", dev, small, RetrySpec("ksplus"), None),
            ("packed", "packed", dev, small, RetrySpec("ksplus"), None),
            ("legacy", "legacy", dev, small, ksplus_retry, None),
            ("fused-cpu", "fused", "cpu", carried, RetrySpec("ksplus"),
             None),
            ("fused-shard1", "fused", dev, small, RetrySpec("ksplus"), 1)):
        aops.reset_launches()
        sim = ClusterSim(nodes(), engine=engine, shard=shard, device=device)
        t0 = time.perf_counter()
        runs[name] = sim.run(wf_.to_jobs(under_frac=0.2, seed=0), retry)
        sync()
        runs[name + "_s"] = time.perf_counter() - t0
        if name == "fused":
            runs["fused_stats"] = dict(sim.stats)
            runs["fused_launches"] = admission_launches(
                sim.stats, f"{DIFF_TASKS}-task fused replay")
    _same_result(runs["packed"], runs["fused-shard1"],
                 f"{DIFF_TASKS} tasks, packed vs fused shard=1")
    for name in ("packed", "legacy", "fused-cpu", "fused-shard1"):
        _same_result(runs["fused"], runs[name], f"{DIFF_TASKS} tasks, fused "
                     f"vs {name}", ("placements", "retries", "unschedulable")
                     if name == "legacy" else RESULT_FIELDS)
    assert_release_order(small.to_jobs(seed=0), runs["fused"].placements)
    rec["differential"] = {
        "tasks": DIFF_TASKS, "retries": runs["fused"].retries,
        "placements": len(runs["fused"].placements),
        "fused_stats": runs["fused_stats"],
        "admission_launches": runs["fused_launches"],
        **{k: v for k, v in runs.items() if k.endswith("_s")}}

    cases = make_suite(*SUITE_GRID)
    t0 = time.perf_counter()
    rows = run_suite(cases, n_tasks=96, device=dev)
    suite_s = time.perf_counter() - t0
    for case, row in zip(cases, rows):
        got = {}
        for engine in ("fused", "packed"):
            fleet = suite_mod._default_nodes()
            got[engine] = ClusterSim(fleet, engine=engine, device=dev).run(
                suite_mod._case_jobs(case, 96, dev), RetrySpec("ksplus"),
                faults=suite_mod._case_faults(case, fleet))
        _same_result(got["fused"], got["packed"], case.name)
        for f in ("retries", "evictions", "starved", "doomed",
                  "unschedulable", "finished"):
            if row[f] != getattr(got["fused"], f):
                raise AssertionError(f"{case.name}: run_suite {f} differs")
    rec["suite"] = {"cases": len(cases), "seconds": suite_s,
                    "evictions": sum(r["evictions"] for r in rows),
                    "retries": sum(r["retries"] for r in rows),
                    "doomed": sum(r["doomed"] for r in rows),
                    "starved": sum(r["starved"] for r in rows)}

    t0 = time.perf_counter()
    card = evaluate_workflow("heavy_tail", device=dev, **KW)
    card_s = time.perf_counter() - t0
    trace = scenarios.get("heavy_tail", seed=KW["seed"], device=dev)
    cpu = evaluate_workflow(
        load_workflow_trace(trace_state(trace), device="cpu"),
        device="cpu", **KW)
    compare_runs(card, cpu, "heavy_tail")
    rec["heavy_tail"] = {"seconds": card.seconds, "wall_s": card_s}

    for table, dt in probes.seen:
        check_grouped(table, dt, err)
    return rec, probes.seen, (adm_calls, script_calls, protocol_calls)


def cluster_probe_entry(seen, launches, err):
    """The kernel line's ``oom_probe`` record at the cluster replay's probe
    table (the largest one): kernel and plain version timed, bound from its
    bytes."""
    from repro_torch.kernels.wastage import ops, ref
    table, dt = max(seen, key=lambda c: c[0].n_lanes)
    nbytes, valid = table_bytes(table, 12)
    kern = time_ms(lambda: ops.oom_probe_groups(table, dt))
    plain = time_ms(lambda: [ref.oom_probe(g.starts, g.peaks, g.mems[:g.B],
                                           g.lengths[:g.B], dt)
                             for g in table.groups])
    return _entry("oom_probe", launches, err, kern, plain, None, nbytes,
                  valid * 5, "the cluster replay's attempt-1 probe: "
                  f"{table.n_lanes} jobs' plans over their traces, one "
                  "launch per dt group", F32_OPS_PER_S,
                  groups=describe(table)[1])


def cluster_profile(tasks=REPLAY_TASKS, profiled=2048):
    """Where phase 11's replay time goes, one JSON line: the fused replay
    of ``workload_replay(tasks)`` under ``cProfile`` (the share of its wall
    time inside ``AdmissionState.drain`` and the drain program), then a
    ``workload_replay(profiled)`` replay under ``torch.profiler``: device
    busy time (the union of its kernels' intervals), idle share, kernel
    count.  Run as ``python3 -c "import chip_smoke;
    chip_smoke.cluster_profile()"`` from the checkout."""
    import cProfile
    import pstats

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import RetrySpec
    from repro_torch.kernels import build
    from repro_torch.kernels.wastage import ops
    from repro_torch.sched import ClusterSim, Node
    from repro_torch.workloads import scenarios

    def replay(n):
        """A replay of ``n`` tasks to run once (``run`` updates its jobs),
        prepared outside the measured window."""
        wf = scenarios.get("workload_replay", n_tasks=n, seed=1,
                           device="cuda")
        sim = ClusterSim([Node(i, c) for i, c in CLUSTER_NODES])
        jobs = wf.to_jobs(under_frac=0.1, seed=1)
        torch.cuda.synchronize()

        def go():
            sim.run(jobs, RetrySpec("ksplus"))
            torch.cuda.synchronize()
            return dict(sim.stats)
        return go

    build.build(ops.SOURCE)
    replay(256)()  # first calls
    run = replay(tasks)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    stats = run()
    prof.disable()
    wall = time.perf_counter() - t0
    cum = {f"{os.path.basename(k[0])}:{k[2]}": v[3] for k, v in
           pstats.Stats(prof).stats.items()
           if k[2] in ("drain", "_drain_fused", "admit_drain", "_book",
                       "_refresh_fused", "_operands", "_run_fused",
                       "process_job_run")}
    out = {"device": device_line(), "tasks": tasks, "cprofile_wall_s": wall,
           "cumulative_s": cum, **stats}
    stats, prof = profile_call(replay(profiled))
    out["profiled"] = {"tasks": profiled, "wall_s": prof["wall_ms"] / 1e3,
                       "device_busy_s": prof["device_busy_ms"] / 1e3,
                       "idle_share": prof["idle_share"],
                       "device_kernels": prof["device_ops"],
                       **stats}
    log(json.dumps(out))


def cluster_phase(err):
    """Phase 11 on the card with its log lines: returns the record, the
    replay's probe tables and the two admission kernels' records."""
    t0 = time.perf_counter()
    rec, seen, calls = cluster_replay(err)
    log(f"phase 11: workload_replay({REPLAY_TASKS}) synthesized on the card "
        f"in {rec['synthesis_s'][0]:.3f} s (again, bitwise the same: "
        f"{rec['synthesis_s'][1]:.3f} s); buckets {rec['buckets']}, "
        f"{rec['trace_bytes']} bytes of traces")
    r = rec["replay"]
    log(f"phase 11: fused replay of {r['tasks']} tasks in {r['wall_s']:.3f} "
        f"s: {r['drains']} drains, {r['drain_dispatches']} drain programs, "
        f"{r['drain_iterations']} drain iterations, {r['host_reads']} host "
        f"reads, admission launches {r['admission_launches']}, "
        f"{r['retries']} retries, "
        f"{r['launches']['oom_probe']} oom_probe launch(es) for "
        f"{r['dt_groups']} dt group(s); release order holds, none "
        f"unschedulable; calls " + json.dumps(r["admission_calls"]))
    sr = rec["replay_shard1"]
    log(f"phase 11: the same replay with the node-sharded drain, shard=1 on "
        f"a one-rank group: {sr['wall_s']:.3f} s, placements equal; "
        f"{sr['drains']} drains, {sr['drain_iterations']} drain iterations, "
        f"{sr['host_reads']} host reads, {sr['collectives']} collectives")
    d = rec["differential"]
    log(f"phase 11: {DIFF_TASKS} tasks fused on the card in "
        f"{d['fused_s']:.3f} s ({d['fused_stats']['drain_iterations']} "
        f"drain iterations, {d['fused_stats']['host_reads']} host reads, "
        f"admission launches {d['admission_launches']}), on the CPU in "
        f"{d['fused-cpu_s']:.3f} s")
    log(f"phase 11: {DIFF_TASKS} tasks fused == packed == legacy == fused on "
        f"the CPU == fused shard=1; run_suite {rec['suite']['cases']} cases "
        f"fused == packed; "
        f"heavy_tail card == cpu ({time.perf_counter() - t0:.1f} s) "
        + json.dumps(rec))
    b = rec["bench_admission"]
    log(f"phase 11: bench_admission's script, {b['lanes']} lanes, "
        f"{b['events'][0]} events of up to {b['events'][1]} admissions: "
        f"card == fused on the CPU == numpy on every placement, "
        f"{b['placements']} placements; card {b['seconds']:.3f} s, fused "
        f"on the CPU {b['fused_cpu_s']:.3f} s, numpy {b['numpy_cpu_s']:.3f}"
        f" s; {b['host_reads']} host reads, admission "
        f"launches {b['admission_launches']}; calls "
        + json.dumps(b["admission_calls"]))
    p = rec["bench_drain"]
    log(f"phase 11: bench_drain's protocol, {p['lanes']} lanes drained at "
        f"{list(p['times'])} s: card == fused on the CPU == numpy, placed "
        f"{p['placed']}; {p['drains']} drains, {p['drain_dispatches']} "
        f"drain programs ({p['dispatches_per_drain']:g} a drain), "
        f"{p['drain_iterations']} drain iterations, {p['host_reads']} host "
        f"reads, admission launches {p['admission_launches']}")
    runs = {"cluster_replay": r, "bench_admission": b, "bench_drain": p}
    main_path = {k: sum(x["admission_launches"][k] for x in runs.values())
                 for k in ("admit_columns", "admit_drain")}
    adm = admission_entries(calls, main_path, err)
    for k in adm:
        k["launches_by_run"] = {name: x["admission_launches"][k["name"]]
                                for name, x in runs.items()}
    for k in adm:
        log(f"phase 11: {k['name']} == plain at the main path's "
            f"kept calls; launches {k['launches_by_run']}; at the largest "
            f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound "
            f"{k['bound_ms']:.5f} by {k['bound_by']}), median over them "
            f"{k['median_ms']:.4f} ms; " + json.dumps(k["calls"]))

    return rec, seen, adm


def admission_bench():
    """Phase 11 alone on the card, with its builds (the wastage and the
    admission sources), then its kernel records as one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.admission import ops as aops
    from repro_torch.kernels.wastage import ops
    log(device_line())
    built = build.build_all([ops.SOURCE, aops.SOURCE])
    path, secs = built["admission"]
    log(f"built {os.path.relpath(path, ROOT)} in {secs:.2f} s: " + json.dumps(
        kernel_report(aops.SOURCE, path, keep=lambda name: "_kernel" in name)))
    err = {}
    _, _, adm = cluster_phase(err)
    print(json.dumps({"kernels": adm}), flush=True)


# ------------------------------------------------------------- phase 12
SERVE_TENANTS = 8
SERVE_INSTANCES = 2000  # sarek(instances_per_family=...): executions a family
TRACED_TASKS = 400      # the traced cluster replay (phase 11's differential)
OBS_TRACE = os.path.join(ROOT, "build", "obs_trace.perfetto.json")


def _sarek_families(instances):
    """``{family: (mems, dts, inputs)}`` of ``sarek(instances)`` at dt 1.0."""
    from repro_torch.traces import sarek
    data = sarek(instances_per_family=instances).generate(0, 1.0)
    return {f: ([e.mem for e in ex], [e.dt for e in ex],
                [e.input_gb for e in ex]) for f, ex in data.items()}


def _timed(fn, dev):
    """``(fn(), seconds)`` on the host clock, ending in a synchronise."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _spread(xs):
    return {"n": len(xs), "mean_s": float(np.mean(xs)),
            "min_s": float(np.min(xs)), "max_s": float(np.max(xs))}


def serve_histories(families, tenants, device):
    """Phase 12 (b) on ``device``: a server whose ``tenants`` share one
    ``ks+`` snapshot per family, seeded on the family's executions; then
    ``evaluate`` for every (tenant, family) and ``tune_offset`` for every
    family (tenant 0's), cold and then warm under ``dispatch_budget(
    compiles=0)`` with ``serve.dev_sync`` forbidden.  Returns the record
    and the results ``{family: (evaluate, tune)}`` of tenant 0's warm
    pass."""
    from repro_torch.analysis.contracts import dispatch_budget
    from repro_torch.serve import PredictionServer
    dev = torch.device(device)
    srv = PredictionServer(device=dev)
    for t in range(tenants):
        srv.add_tenant(f"tenant{t}")
    _, seed_s = _timed(lambda: [srv.seed_family(f, "ks+", *data)
                                for f, data in families.items()], dev)
    rec = {"device": str(dev), "tenants": tenants,
           "families": len(families), "seed_s": seed_s}
    results = {}
    for phase, budget in (("cold", {}), ("warm", {
            "compiles": 0, "forbid": ("serve.dev_sync",)})):
        ev_s, tune_s = [], []
        with dispatch_budget(**budget) as b:
            for t in range(tenants):
                client = srv.client(f"tenant{t}")
                for f in families:
                    res, secs = _timed(lambda: client.evaluate(f), dev)
                    ev_s.append(secs)
                    if t == 0:
                        results[f] = [res]
            client = srv.client("tenant0")
            for f in families:
                res, secs = _timed(lambda: client.tune_offset(f), dev)
                tune_s.append(secs)
                results[f].append(res)
        rec[phase] = {"evaluate": _spread(ev_s), "tune": _spread(tune_s),
                      "compiles": b.compiles,
                      "dispatches": dict(b.tag_counts)}
        want_sync = tenants * len(families) if phase == "cold" else 0
        if b.tag_counts["serve.dev_sync"] != want_sync:
            raise AssertionError(
                f"serve {phase}: serve.dev_sync fired "
                f"{b.tag_counts['serve.dev_sync']} times, want {want_sync} "
                f"(one per tenant, family and snapshot, cold only)")
        want_engine = tenants * len(families) + len(families)
        if b.tag_counts["fleet.engine"] != want_engine:
            raise AssertionError(
                f"serve {phase}: {b.tag_counts['fleet.engine']} fleet.engine"
                f" dispatches for {want_engine} evaluate and tune calls")
    return rec, results


def traced_replay(device="cuda"):
    """Phase 12 (c): the ``TRACED_TASKS``-task ``workload_replay`` (seed 0,
    ``under_frac=0.2``) through ``ClusterSim(engine="fused")`` untraced and
    traced: placements, retries, evictions and wastage bitwise equal, and
    one ``admission.drain`` dispatch per drain.  Writes the trace and
    returns the record with ``summarize()``'s table."""
    from repro_torch import obs
    from repro_torch.analysis.contracts import dispatch_budget
    from repro_torch.core import RetrySpec
    from repro_torch.sched import ClusterSim, Node
    from repro_torch.workloads import scenarios
    dev = torch.device(device)
    wf = scenarios.get("workload_replay", n_tasks=TRACED_TASKS, seed=0,
                       device=dev)
    runs = {}
    for traced in (False, True):
        sim = ClusterSim([Node(n, c) for n, c in CLUSTER_NODES],
                         engine="fused", device=dev)
        jobs = wf.to_jobs(under_frac=0.2, seed=0)
        obs.clear()
        with dispatch_budget() as b:
            res, secs = _timed(lambda: sim.run(jobs, RetrySpec("ksplus"),
                                               trace=traced), dev)
        runs[traced] = (res, secs, dict(sim.stats), b.tag_counts)
    (base, base_s, base_st, _), (res, secs, st, tags) = runs[False], \
        runs[True]
    for f in ("placements", "retries", "evictions", "starved", "doomed",
              "unschedulable", "total_wastage_gbs"):
        if getattr(res, f) != getattr(base, f):
            raise AssertionError(f"traced replay: {f} differs from the "
                                 f"untraced one")
    if st != base_st:
        raise AssertionError(f"traced replay stats {st} vs {base_st}")
    if tags["admission.drain"] != st["drains"]:
        raise AssertionError(f"{tags['admission.drain']} admission.drain "
                             f"dispatches for {st['drains']} drains")
    evs = obs.events()
    if sum(e["name"] == "admission.drain" for e in evs) != st["drains"]:
        raise AssertionError("one admission.drain span per drain")
    os.makedirs(os.path.dirname(OBS_TRACE), exist_ok=True)
    n_events = obs.write_chrome_trace(OBS_TRACE, evs)
    obs.clear()
    return {"tasks": TRACED_TASKS, "untraced_s": base_s, "traced_s": secs,
            "retries": res.retries, "placements": len(res.placements),
            "dispatches": dict(tags), **st, "events": n_events,
            "trace": os.path.relpath(OBS_TRACE, ROOT),
            "summary": obs.summarize(evs)}


def prediction_service(err, device="cuda"):
    """Phase 12 (see the module docstring) on ``device``, against the same
    work on the CPU; returns its record and the ``fleet_engine`` group
    tables (b) launched.  (``device="cpu"`` rehearses it; the CPU side
    then repeats itself.)"""
    from repro_torch.analysis.contracts import dispatch_budget
    from repro_torch.kernels.wastage import ops
    from repro_torch.launch.serve import serve_demo
    from repro_torch.serve.bench import run_saturation
    dev = torch.device(device)
    rec = {}

    # (a) the saturation benchmark at the reference's defaults
    ops.reset_launches()
    with dispatch_budget() as b:
        sat, secs = _timed(lambda: run_saturation(device=dev), dev)
    launches = dict(ops.LAUNCHES)
    thr, lat, disc = sat["throughput"], sat["latency"], sat["discipline"]
    if not (thr["bitwise"] and disc["warm_zero_compiles"]
            and disc["cache_hit_ok"]):
        raise AssertionError(f"run_saturation: bitwise {thr['bitwise']}, "
                             f"warm_zero_compiles "
                             f"{disc['warm_zero_compiles']}, cache_hit_ok "
                             f"{disc['cache_hit_ok']}")
    want = b.tag_counts["fleet.engine"] if dev.type == "cuda" else 0
    if launches != {"oom_probe": 0, "wastage_eval": 0, "fleet_engine": want} \
            or b.tag_counts["fleet.engine"] <= 0:
        raise AssertionError(f"run_saturation launched {launches} for "
                             f"{b.tag_counts['fleet.engine']} fleet calls")
    rec["saturation"] = {**sat, "seconds": secs, "launches": launches}

    # (b) sarek(2000) histories, on the card and on the CPU
    families = _sarek_families(SERVE_INSTANCES)
    ops.reset_launches()
    with engine_tables(ops) as tables:
        card, card_res = serve_histories(families, SERVE_TENANTS, dev)
    launches = dict(ops.LAUNCHES)
    calls = 2 * (SERVE_TENANTS * len(families) + len(families))
    want = calls if dev.type == "cuda" else 0
    if launches != {"oom_probe": 0, "wastage_eval": 0, "fleet_engine": want}:
        raise AssertionError(f"serve histories launched {launches}, want "
                             f"one fleet_engine per evaluate dispatch and "
                             f"per tune group ({calls})")
    cpu, cpu_res = serve_histories(families, 1, "cpu")
    for f in families:
        (ea, ta), (eb, tb) = card_res[f], cpu_res[f]
        if (ea.n, ea.succeeded, ea.mean_attempts) != (
                eb.n, eb.succeeded, eb.mean_attempts):
            raise AssertionError(f"evaluate {f}: card {ea} vs cpu {eb}")
        np.testing.assert_allclose(ea.total_gbs, eb.total_gbs, rtol=1e-4,
                                   err_msg=f"evaluate {f}")
        if ta.best != tb.best:
            raise AssertionError(f"tune_offset {f}: card {ta.best} vs cpu "
                                 f"{tb.best}")
        np.testing.assert_allclose(ta.totals, tb.totals, rtol=1e-4,
                                   err_msg=f"tune_offset {f}")
    rec["histories"] = {
        "instances": SERVE_INSTANCES, "launches": launches, "card": card,
        "cpu": cpu, "total_gbs": {f: r[0].total_gbs
                                  for f, r in card_res.items()},
        "best": {f: [r[1].best.peak, r[1].best.start,
                     r[1].best.last_peak_bump]
                 for f, r in card_res.items()}}

    # (c) tracing only observes
    rec["traced"] = traced_replay(dev)

    # (d) serve_demo on the card and on the CPU
    got, secs = _timed(lambda: serve_demo("qwen3-1.7b", device=dev), dev)
    want = serve_demo("qwen3-1.7b", device="cpu")
    if (got["served"], got["batches"]) != (want["served"], want["batches"]):
        raise AssertionError(f"serve_demo: card {got} vs cpu {want}")
    rec["serve_demo"] = {**got, "wall_s": secs, "cpu": want}
    # largest first: the table whose launch must move the most bytes
    return rec, sorted(tables.seen, key=lambda c: -table_bytes(
        c[0], 4 + 4 + 1, engine=True)[0])


def serve_engine_entry(entry, recorded, launches, err):
    """The ``fleet_engine`` record's serve side: the kernel against the
    plain engine at every table phase 12 launched, then timed at the
    largest, ``recorded[0]`` (a tune group: every candidate's lanes in one
    launch)."""
    from repro_torch.kernels.wastage import ops, ref
    lanes = check_engine([(f"serve {describe(t)[1]}", t, mm, dt, n)
                          for t, mm, dt, n in recorded], err)
    etable, mm, dt, max_attempts = recorded[0]
    nbytes, valid = table_bytes(etable, 4 + 4 + 1, engine=True)
    buckets = len({g.mems.data_ptr() for g in etable.groups})
    jobs = len(etable.groups) // buckets
    ms = time_ms(lambda: ops.fleet_engine(etable, mm, dt, max_attempts))
    plain_ms = time_ms(lambda: ref.plain_engine(etable, mm, dt,
                                                max_attempts))
    serve = _entry("fleet_engine", {"fleet_engine": launches}, err, ms,
                   plain_ms, None, nbytes, valid * jobs,
                   f"the largest serve call: tune_offset's {jobs} "
                   f"candidates over one family's {etable.n_lanes // jobs} "
                   "executions in one launch", F32_OPS_PER_S,
                   groups=describe(etable)[1])
    entry["serve"] = {k: serve[k] for k in (
        "launches", "ms", "plain_ms", "bound_ms", "bound_by", "bytes",
        "ops", "timed", "groups")}
    entry["serve"]["tables_checked"] = len(recorded)
    entry["serve"]["lanes_checked"] = lanes
    entry["max_abs_err"] = err.get("fleet_engine")
    return entry["serve"]


def serve_bench():
    """Phase 12 alone on the card, one JSON line (and the replay's span
    table): ``python3 -c "import chip_smoke; chip_smoke.serve_bench()"``
    from the checkout."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.wastage import ops
    build.build(ops.SOURCE)
    err = {}
    t0 = time.perf_counter()
    rec, tables = prediction_service(err)
    secs = time.perf_counter() - t0
    entry = {"name": "fleet_engine"}
    serve = serve_engine_entry(entry, tables,
                               rec["histories"]["launches"]["fleet_engine"],
                               err)
    log(rec["traced"].pop("summary"))
    log(json.dumps({"device": device_line(), "phase13_s": secs,
                    "fleet_engine_serve": serve, **rec}))


def replay_time(runs=1):
    """Phase 11's fused replay of ``workload_replay(REPLAY_TASKS)`` timed
    ``runs`` times on whatever ``repro_torch`` is importable, one JSON
    line each; with an earlier tree's ``src`` first on ``sys.path`` (see
    :func:`fleet_split`) it times that tree's replay."""
    import repro_torch
    from repro_torch.core import RetrySpec
    from repro_torch.kernels import build
    from repro_torch.kernels.wastage import ops
    from repro_torch.sched import ClusterSim, Node
    from repro_torch.workloads import scenarios
    build.build(ops.SOURCE)
    wf = scenarios.get("workload_replay", n_tasks=REPLAY_TASKS, seed=1,
                       device="cuda")
    for i in range(runs):
        sim = ClusterSim([Node(n, c) for n, c in CLUSTER_NODES],
                         engine="fused")
        jobs = wf.to_jobs(under_frac=0.1, seed=1)
        res, secs = _timed(lambda: sim.run(jobs, RetrySpec("ksplus")),
                           torch.device("cuda"))
        log(json.dumps({"run": i, "replay_s": secs, "retries": res.retries,
                        **sim.stats, "device": device_line(),
                        "package": os.path.dirname(repro_torch.__file__)}))


# ------------------------------------------------------------- phase 13
def _bwd_close(got, want, dtype, what, err, name):
    """float32: within 1e-4 of the tensor's largest |want| (and 1e-4 of
    each element); bf16: 2e-2 of each element plus 2e-2 of the largest."""
    scale = max(float(want.float().abs().max()), 1e-30)
    rtol, atol = ((1e-4, 1e-4 * scale) if dtype == torch.float32
                  else (2e-2, 2e-2 * scale))
    _close(got, want, (rtol, atol), what, err, name)


def layout_of(model, opt, batch):
    """Where a training step's tensors live: whether every parameter,
    moment and batch array is a DTensor, and their meshes' shapes and
    device types."""
    from torch.distributed.tensor import DTensor
    ts = list(model.parameters()) + list(opt["m"].values()) \
        + list(opt["v"].values()) + list(batch.values())
    meshes = {(tuple(t.device_mesh.shape), t.device_mesh.device_type)
              for t in ts if isinstance(t, DTensor)}
    return {"all_dtensor": all(isinstance(t, DTensor) for t in ts),
            "meshes": sorted(meshes),
            "placements": sorted({str(t.placements) for t in ts
                                  if isinstance(t, DTensor)})}


class TrainSteps:
    """While active, ``launch.train``'s ``make_train_step`` hands out steps
    that record each step's kernel launches (the six LM counters, read
    just before and just after the step) and run step ``profile_at`` under
    ``torch.profiler``.  It only records."""

    def __init__(self, profile_at=None):
        from repro_torch.launch import train as train_mod
        self.mod, self.profile_at = train_mod, profile_at
        self.launches, self.profile = [], None

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.mamba2_mix import ops as mops
        from repro_torch.kernels.ssd import ops as sops
        self.orig = orig = self.mod.make_train_step

        def counts():
            return {**sops.LAUNCHES, **fops.LAUNCHES, **mops.LAUNCHES}

        def make(*args, **kw):
            step_fn = orig(*args, **kw)

            def step(model, opt, batch, i):
                before = counts()
                self.layout = layout_of(model, opt, batch)
                self.allocated_before = torch.cuda.memory_allocated()
                self.args_bytes = tensor_bytes(model, opt, batch)
                if i == self.profile_at:
                    out, self.profile = profile_call(
                        lambda: step_fn(model, opt, batch, i))
                else:
                    out = step_fn(model, opt, batch, i)
                after = counts()
                self.launches.append({k: after[k] - before[k]
                                      for k in after})
                return out
            return step
        self.mod.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.orig


# The backward kernels' times before their Hopper redesign (PR 17's
# CUDA-core designs, NVIDIA H100 80GB HBM3 at 700 W, PERF.md), printed
# beside this run's for reference.
PR17_BWD_MS = {"flash_attention_bwd": 7.680, "ssd_bwd": 2.363}

PER_HEAD_GRADS = ("A_log", "dt_bias")


def train_card_vs_cpu(dtype_name, seed=1, S=300, cfg=None):
    """Phase 13 (b): one ``train_step`` of the full-width model cut to 6
    Mamba2 blocks + the shared block (or of ``cfg``: phase 14 (b)), B = 1,
    on the card against the plain path on the CPU with the same weights
    and batch: the loss and every
    gradient (each side's ``forward_train`` then ``torch.autograd.grad``,
    what the step computes, before the step); then every parameter after
    the card's AdamW step against the CPU's AdamW fed the card's gradients
    (fed its own, an element whose gradient is ~0 may step either way by a
    sign the tolerance cannot hold).  Tolerances are phase 9's: f32 1e-3
    of each element plus 1e-3 of the tensor's largest, bf16 3e-2 of each;
    in bf16 the per-head gradients (``A_log``, ``dt_bias``) are instead
    held to a relative L2 error of 0.1.  They are sums over the tokens of
    terms rounded to bf16 on the way (``dA`` and ``dX``, as the reference
    rounds ``Adt`` and ``X``); where a sum cancels, card and CPU differ by
    more than 3e-2 of the tensor's largest element (``A_log``: 1.15e-6
    against 7.55e-7 allowed, one element in 80), while the relative L2
    error stays at 3.1-3.4 % and the float32 run agrees to 2.5e-7
    everywhere.  In bf16 those rules hold the card's plain route (the
    mixers' plain version); through the mix kernels, which take the conv,
    the gate and the norm in float32 where the plain path rounds each step
    to bf16, the card's gradients are instead held to be at least as near
    the float32 step's (same weights and batch, on the card) as the CPU's,
    each in relative L2: against the CPU elementwise, sums that cancel
    differ by more than the rule (8 of 66 tensors, one to a few elements
    each, while every one of the 66 is nearer float32).  Returns the
    elementwise record and that of the nearness."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import host_batch
    from repro_torch.models import decayed, forward_train, init_params
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.runtime import make_train_step
    if cfg is None:
        cfg = dataclasses.replace(get_config(ARCH), n_layers=6,
                                  dtype=dtype_name, remat="none")
    card = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    cpu = init_params(cfg, None, device="cpu")
    cpu.load_state_dict(card.state_dict())
    batch = {k: torch.as_tensor(v) for k, v in
             host_batch(cfg, S, 1, 1, seed=seed).items()}
    card_batch = {k: v.cuda() for k, v in batch.items()}
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops

    def loss_and_grads(model, cfg, bt):
        named = dict(model.named_parameters())
        loss, _ = forward_train(model, cfg, bt)
        return loss.detach(), dict(zip(named, torch.autograd.grad(
            loss, list(named.values()))))

    sides = {}
    before = (sops.LAUNCHES["ssd"], dict(mops.LAUNCHES))
    sides["card"] = loss_and_grads(card, cfg, card_batch)
    # one mix_in and one mix_out a Mamba2 layer, as many as the scans
    n_ssd = sops.LAUNCHES["ssd"] - before[0]
    mixed = {k: v - before[1][k] for k, v in mops.LAUNCHES.items()}
    if mixed != {"mix_in": n_ssd, "mix_out": n_ssd}:
        raise AssertionError(f"{dtype_name} train forward on the card: mix "
                             f"launches {mixed}, want {n_ssd} each")
    sides["cpu"] = loss_and_grads(cpu, cfg, batch)
    if dtype_name != "float32":
        # the card's plain route (the mixers' plain version, the route
        # before the mix kernels), and the step in float32 on the card
        on_card = mops._on_card
        mops._on_card = lambda t: False
        try:
            sides["card_plain"] = loss_and_grads(card, cfg, card_batch)
        finally:
            mops._on_card = on_card
        f32 = dataclasses.replace(cfg, dtype="float32")
        exact = init_params(f32, None, device="cuda")
        exact.load_state_dict(card.state_dict())
        sides["float32"] = loss_and_grads(exact, f32, card_batch)
        del exact
    step_fn = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1,
                              total_steps=10)
    m = step_fn(card, adamw_init(dict(card.named_parameters())), card_batch,
                1)
    worst = {}

    def close(what, a, b):
        a, b = a.detach().float().cpu(), b.detach().float()
        scale = float(b.abs().max())
        rel_l2 = float(torch.linalg.vector_norm(a - b)
                       / torch.linalg.vector_norm(b).clamp_min(1e-30))
        tol = 1e-3 if dtype_name == "float32" else 3e-2
        if dtype_name != "float32" and what.startswith("grad") \
                and what.rsplit(".", 1)[-1] in PER_HEAD_GRADS:
            if rel_l2 > 0.1:
                raise AssertionError(f"{dtype_name} {what}: relative L2 "
                                     f"{rel_l2:.4f} > 0.1")
        else:
            torch.testing.assert_close(
                a, b, rtol=tol, atol=tol * scale,
                msg=lambda x: f"{dtype_name} {what}: {x}")
        worst[what] = (float((a - b).abs().max()), scale, rel_l2)

    def nearer(what, a, b, exact):
        """The card's bf16 gradient at least as near the float32 one as
        the CPU's (relative L2)."""
        exact = exact.detach().float()
        norm = float(torch.linalg.vector_norm(exact)) or 1e-30
        e_card = float(torch.linalg.vector_norm(a.detach().float() - exact))
        e_cpu = float(torch.linalg.vector_norm(b.detach().float().cuda()
                                               - exact))
        if e_card > e_cpu:
            raise AssertionError(
                f"{dtype_name} {what}: the card {e_card / norm:.4g} from "
                f"float32, the cpu {e_cpu / norm:.4g}")
        nearest[what] = (e_card / norm, e_cpu / norm)

    card_grads = sides["card"][1]
    loss, grads = sides["cpu"]
    nearest = {}
    close("loss", sides["card"][0], loss)
    close("loss after the step", m["loss"], loss)
    for n, g in grads.items():
        if dtype_name == "float32":
            close(f"grad {n}", card_grads[n], g)
        else:
            close(f"grad {n}", sides["card_plain"][1][n], g)  # plain route
            nearer(f"grad {n}", card_grads[n], g, sides["float32"][1][n])
    named = dict(cpu.named_parameters())
    adamw_update({n: g.cpu() for n, g in card_grads.items()},
                 adamw_init(named), named, lr=m["lr"],
                 decay=decayed(cfg, named))
    for n, p in card.named_parameters():
        close(f"param {n}", p, named[n])
    return worst, nearest


def train_full(seq=2048, steps=8):
    """Phase 13 (c), first part: ``launch.train.train`` of zamba2-2.7b at
    full width and depth, ``remat="none"`` as the reference's ``train``
    sets it; the launch counters are set to 0 just before and read just
    after.  Returns its record; raises unless every loss is finite and
    every step launched exactly one ``ssd``, ``ssd_bwd``, ``mix_in`` and
    ``mix_out`` per Mamba2 block (the mix kernels' backward is their plain
    version's, recomputed: no launch) and one ``flash_attention`` and
    ``flash_attention_bwd`` per shared-block application, on the mesh's
    local shards."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.launch.train import train
    cfg = get_config(ARCH)
    for o in (sops, fops, mops):
        o.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with TrainSteps(profile_at=steps - 1) as rec:
        out = train(ARCH, smoke=False, seq=seq, batch=1, steps=steps,
                    monitor=True, log_every=1)
    launches = {**sops.LAUNCHES, **fops.LAUNCHES, **mops.LAUNCHES}
    n_ssd = cfg.n_layers
    n_attn = cfg.n_layers // cfg.shared_attn_every
    want = {"ssd": n_ssd, "ssd_bwd": n_ssd, "flash_attention": n_attn,
            "flash_attention_bwd": n_attn, "mix_in": n_ssd,
            "mix_out": n_ssd}
    for i, got in enumerate(rec.launches):
        if got != want:
            raise AssertionError(f"train step {i} launched {got}, want "
                                 f"{want}")
    if len(rec.launches) != steps or out["status"] != "done":
        raise AssertionError(f"train ran {len(rec.launches)} steps: {out}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss {out['losses']}")
    if not rec.layout["all_dtensor"] \
            or rec.layout["meshes"] != [((1, 1), "cuda")]:
        raise AssertionError(f"train stepped off the (1, 1) CUDA mesh: "
                             f"{rec.layout}")
    step_s = float(np.median(out["step_s"][1:]))
    prof = rec.profile
    prof.pop("result", None)
    return {"seq": seq, "batch": 1, "steps": steps, "losses": out["losses"],
            "layout": rec.layout,
            "step_s": out["step_s"], "median_step_s": step_s,
            "tokens_per_s": seq / step_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "rss_trace_gb": out.get("rss_trace_gb"),
            "launches": launches, "launches_per_step": want,
            "step_memory": step_memory(rec.allocated_before,
                                       rec.args_bytes),
            "profile_last_step": prof}


def train_remat(batch=2, seq=2048, steps=3):
    """Phase 13 (c), second part: ``make_train_step`` with the config's own
    ``remat="full"`` at ``batch`` x ``seq``: each super-layer runs forward
    again in the backward, so the forward kernels launch twice a step."""
    from repro_torch.configs import get_config
    from repro_torch.data import host_batch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import make_train_step
    cfg = get_config(ARCH)
    assert cfg.remat == "full"
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, total_steps=steps)
    n_ssd = cfg.n_layers
    n_attn = cfg.n_layers // cfg.shared_attn_every
    want = {"ssd": 2 * n_ssd, "ssd_bwd": n_ssd,
            "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
            "mix_in": 2 * n_ssd, "mix_out": 2 * n_ssd}
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for step in range(steps):
        bt = {k: torch.as_tensor(v, device="cuda") for k, v in
              host_batch(cfg, seq, batch, step).items()}
        for o in (sops, fops, mops):
            o.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(model, opt, bt, step)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        got = {**sops.LAUNCHES, **fops.LAUNCHES, **mops.LAUNCHES}
        if got != want:
            raise AssertionError(f"remat step {step} launched {got}, want "
                                 f"{want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite remat loss {losses}")
    return {"batch": batch, "seq": seq, "steps": steps, "losses": losses,
            "step_s": secs, "tokens_per_s": batch * seq
            / float(np.median(secs[1:])),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": want}


TRAIN_CKPT = os.path.join(ROOT, "build", "train_ckpt_smoke")


def train_fault_tolerance():
    """Phase 13 (d): zamba2-smoke on the card with checkpoints every 3
    steps, killed at step 5 and resumed from step 3: the resumed losses are
    bitwise those of an uninterrupted run."""
    from repro_torch.launch.train import train
    kw = dict(steps=8, seq=64, batch=2, ckpt_every=3, monitor=False)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    with TrainSteps() as rec:
        full = train("zamba2-2.7b", **kw)
    if not rec.layout["all_dtensor"]:
        raise AssertionError(f"smoke training off the mesh: {rec.layout}")
    killed = train("zamba2-2.7b", ckpt_dir=TRAIN_CKPT, kill_at_step=5, **kw)
    resumed = train("zamba2-2.7b", ckpt_dir=TRAIN_CKPT, resume=True, **kw)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    if killed["losses"] != full["losses"][:5] \
            or resumed["losses"] != full["losses"][3:]:
        raise AssertionError(f"resumed losses {resumed['losses']} (killed "
                             f"{killed['losses']}) vs uninterrupted "
                             f"{full['losses']}")
    return {"losses": full["losses"], "killed_at": killed["step"],
            "resumed_from": 3, "layout": rec.layout}


def bwd_kernel_timings(launches, err):
    """Phase 13 (e): both backward kernels at the 1 x 2048 training shapes,
    bf16, beside their plain versions, their bounds and (attention) the
    backward of ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    cfg = get_config(ARCH)
    Bsz, S = 1, 2048
    rng = np.random.default_rng(6)
    bf = torch.bfloat16
    out = []

    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v, _, _ = flash_case(rng, Bsz, S, S, H, K, hd, bf)
    o, lse = fops._forward(q, k, v, True, None, with_lse=True)
    do = torch.as_tensor(rng.standard_normal(q.shape), dtype=torch.float32,
                         device="cuda").to(bf)
    got = fops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    want = fops.ref.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, "qkv"):
        _bwd_close(g, w, bf, f"flash_attention_bwd d{t} at the training "
                   f"shape", err, "flash_attention_bwd")
    del got, want
    ms = time_ms(lambda: fops.flash_attention_bwd(q, k, v, o, do, lse,
                                                  causal=True))
    plain_ms = time_ms(lambda: fops.ref.flash_attention_bwd(
        q, k, v, o, do, lse, causal=True), reps=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).backward(
            dot)
    lib_ms = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
    # q, k, v, o, dO read once and dq, dk, dv written once (bf16), lse
    # read; products: 2.5x the forward's over the causal pairs (five
    # products of the forward's size against its two)
    nbytes = fops.io_bytes(Bsz, S, S, H, K, hd, 2, backward=True)
    nops = fops.flops(Bsz, S, S, H, hd, True, None, backward=True)
    out.append(_entry("flash_attention_bwd", launches, err, ms, plain_ms,
                      lib_ms, nbytes, nops,
                      f"causal backward, q/k/v/o/dO ({Bsz}, {S}, {H}, {hd}) "
                      f"bf16; library = SDPA forward+backward minus forward",
                      shape=dict(B=Bsz, Sq=S, Skv=S, H=H, K=K, hd=hd,
                                 causal=True, window=None)))
    del q, k, v, o, do, qt, kt, vt, dot

    Hs, P, G, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups, \
        cfg.ssm_state
    X, A, Bm, Cm, chunk = ssd_case(rng, Bsz, S, Hs, P, G, N, cfg.ssm_chunk,
                                   bf)
    dY = torch.as_tensor(rng.standard_normal(X.shape), dtype=torch.float32,
                         device="cuda").to(bf)
    # as training calls it: with the bf16 forward's entering states
    _, _, states = sops._forward(X, A, Bm, Cm, chunk)
    got = sops.ssd_bwd(X, A, Bm, Cm, chunk, dY, states=states)
    want = sops.ref.ssd_bwd(X, A, Bm, Cm, chunk, dY)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, ("X", "A", "Bm", "Cm")):
        _bwd_close(g, w, bf, f"ssd_bwd d{t} at the training shape", err,
                   "ssd_bwd")
    del got, want
    ms = time_ms(lambda: sops.ssd_bwd(X, A, Bm, Cm, chunk, dY,
                                      states=states))
    ms_alone = time_ms(lambda: sops.ssd_bwd(X, A, Bm, Cm, chunk, dY))
    plain_ms = time_ms(lambda: sops.ref.ssd_bwd(X, A, Bm, Cm, chunk, dY),
                       reps=5)
    # x, a, B, C, dY read once, dx, da, dB, dC written once (bf16); the
    # products: twice the forward's in the fixed 64-row form (each forward
    # product has two gradient products); scratch counts against the time.
    # The per-head dB, dC partials (float32, written and read once each)
    # are the largest scratch term: a second bound counts them.
    nbytes = sops.io_bytes(Bsz, S, Hs, P, G, N, 2, backward=True)
    partials = 2 * 2 * Bsz * S * Hs * N * 4
    nops = sops.flops(Bsz, S, Hs, P, N, backward=True)
    out.append(_entry(
        "ssd_bwd", launches, err, ms, plain_ms, None, nbytes, nops,
        f"backward scan, x/dY ({Bsz}, {S}, {Hs}, {P}), G={G} N={N} bf16, "
        f"with the forward's entering states",
        shape=dict(B=Bsz, S=S, H=Hs, P=P, G=G, N=N),
        ms_without_states=ms_alone,
        bound_with_partials_ms=max((nbytes + partials) / HBM_BYTES_PER_S,
                                   nops / BF16_OPS_PER_S) * 1e3))
    return out


def training(kernels, err, built):
    """Phase 13 (see the module docstring); appends the backward kernels'
    records to ``kernels``."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    for name, src in (("ssd", sops.SOURCE), ("flash_attention", fops.SOURCE)):
        log(f"phase 13: {name} backward kernels (registers, [spill store, "
            f"spill load] bytes, HGMMA instructions): " + json.dumps(
                kernel_report(src, built[name][0],
                              keep=lambda n: "bwd" in n)))
    for dtype_name in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        worst, nearest = train_card_vs_cpu(dtype_name)
        diff = max(d for d, _, _ in worst.values())
        rel = max(r for _, _, r in worst.values())
        n_grads = sum(k.startswith("grad") for k in worst)
        per_head = max(r for k, (_, _, r) in worst.items()
                       if k.startswith("grad")
                       and k.rsplit(".", 1)[-1] in PER_HEAD_GRADS)
        log(f"phase 13: {ARCH} 6 Mamba2 blocks + shared block, {dtype_name},"
            f" train_step card == cpu: loss, {n_grads}"
            f" gradients and parameters after AdamW; max abs diff {diff:.3g},"
            f" max relative L2 {rel:.3g} (per-head gradients {per_head:.3g})"
            f" ({time.perf_counter() - t0:.1f} s); loss (diff, value, rel)"
            f" {worst['loss']}")
        if nearest:
            log(f"phase 13: {dtype_name} gradients through the mix kernels "
                f"at least as near float32 as the cpu's in all "
                f"{len(nearest)} (relative L2, largest: card "
                f"{max(a for a, _ in nearest.values()):.4g}, cpu "
                f"{max(b for _, b in nearest.values()):.4g})")
    torch.cuda.empty_cache()
    full = train_full()
    prof = full["profile_last_step"]
    log(f"phase 13: {ARCH} launch.train.train 1 x 2048, remat none, on "
        f"the local mesh {full['layout']}: "
        f"{full['median_step_s']:.4f} s per step (median after the first), "
        f"{full['tokens_per_s']:.1f} tokens/s, peak "
        f"{full['peak_gb']:.2f} GB; launches per step "
        f"{full['launches_per_step']}; losses {full['losses']}")
    log("phase 13: profiled last step " + json.dumps(prof))
    torch.cuda.empty_cache()
    rem = train_remat()
    log(f"phase 13: {ARCH} make_train_step remat full 2 x 2048: step s "
        f"{[round(x, 4) for x in rem['step_s']]}, {rem['tokens_per_s']:.1f} "
        f"tokens/s, peak {rem['peak_gb']:.2f} GB; launches per step "
        f"{rem['launches_per_step']}; losses {rem['losses']}")
    torch.cuda.empty_cache()
    ft = train_fault_tolerance()
    log(f"phase 13: zamba2-smoke killed at step {ft['killed_at']}, resumed "
        f"from step {ft['resumed_from']}: losses bitwise the uninterrupted "
        f"run's {ft['losses']}")
    bwd = bwd_kernel_timings(full["launches"], err)
    for k in bwd:
        log(f"phase 13: {k['name']} {k['ms']:.4f} ms (PR 17's CUDA-core "
            f"design: {PR17_BWD_MS[k['name']]} ms; plain "
            f"{k['plain_ms']:.4f}, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.4f} by {k['bound_by']}"
            + (f"; {k['ms_without_states']:.4f} ms computing the entering "
               f"states itself; bound with the per-head partials "
               f"{k['bound_with_partials_ms']:.4f}" if k["name"] == "ssd_bwd"
               else "") + ")")
    for k in kernels:
        if k["name"] in ("ssd", "flash_attention"):
            k["train_launches"] = full["launches"][k["name"]]
    kernels += bwd
    log("phase 13: records " + json.dumps({"train": full, "remat": rem,
                                           "fault_tolerance": ft}))
    return full


def train_bench():
    """Phase 13 alone on the card (with its builds), for bring-up."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    log(device_line())
    built = build.build_all([sops.SOURCE, fops.SOURCE, mops.SOURCE])
    kernels = []
    err = dict.fromkeys(list(REPLACES), 0.0)
    training(kernels, err, built)
    print(json.dumps({"kernels": kernels}), flush=True)



# ------------------------------------------------------------- phase 14
OLMOE, QWEN_VL, HUBERT = "olmoe-1b-7b", "qwen2-vl-72b", "hubert-xlarge"
# (B, prompt, cap): the olmoe decode cell's longer batch
OLMOE_DECODE = (32, 1536, 1792)
VLM_LAYERS = 4              # qwen2-vl-72b's 80 layers cut to fit one card
VLM_BATCHES = ((2, 2048),)
VLM_NEW_TOKENS = 16
VLM_GRID_WIDTH = 64         # patches per image row: 2048 = 32 x 64
AUDIO_BATCH = (4, 1500)     # 30 s clips at the stubbed frontend's 20 ms
AUDIO_CHECK_LAYERS = 6


class Routes:
    """While active, records every routing ``models.moe.route`` returns (its
    callers look it up in the module at each call), moved to the host."""

    def __enter__(self):
        from repro_torch.models import moe
        self.module, self.orig, self.seen = moe, moe.route, []

        def recorded(*args, **kwargs):
            r = self.orig(*args, **kwargs)
            self.seen.append(type(r)(*(t.detach().cpu() for t in r)))
            return r
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.module.route = self.orig


def same_routing(a, b):
    """Per token, the same set of experts; per sorted entry the same slot
    and keep (both invariant to the order of experts within a token, the
    one thing ``topk`` may order differently on near-equal values)."""
    return (torch.equal(a.expert_idx.sort(-1).values,
                        b.expert_idx.sort(-1).values)
            and torch.equal(a.slot, b.slot) and torch.equal(a.keep, b.keep))


def routing_agreement(card, cpu, k):
    """Share of (routing call, token) pairs whose expert sets agree, and
    the CPU's k-th minus (k+1)-th router probability at the tokens that
    disagree (min, max)."""
    agree = total = 0
    gaps = []
    for a, b in zip(card, cpu, strict=True):
        sa = a.expert_idx.sort(-1).values
        sb = b.expert_idx.sort(-1).values
        ok = (sa == sb).all(-1)
        agree += int(ok.sum())
        total += ok.numel()
        top = b.probs.topk(k + 1, dim=-1).values
        gaps += (top[..., k - 1] - top[..., k])[~ok].tolist()
    return {"agree_share": agree / total, "tokens": total,
            "disagree": total - agree,
            "gap_min": min(gaps) if gaps else None,
            "gap_max": max(gaps) if gaps else None}


def grid_feed(cfg, width=VLM_GRID_WIDTH):
    """``serve_demo``'s vlm feed with the positions of an image: the
    temporal id fixed, the height and width ids of a ``width``-patch row
    grid."""
    from repro_torch.launch.serve import vlm_feed

    def feed(rng, Bsz, S):
        batch = vlm_feed(cfg, rng, Bsz, S, "cuda")
        i = torch.arange(S, dtype=torch.int32, device="cuda")
        grid = torch.stack([torch.zeros_like(i), i // width, i % width], -1)
        batch["positions"] = grid[None].expand(Bsz, S, 3)
        return batch
    return feed


def check_served(records, want_flash, what):
    """Exactly ``want_flash`` attention launches per prefill, none in
    decode, no ``ssd`` launch, finite logits."""
    for r in records:
        if r["prefill_launches"] != {"ssd": 0, "flash_attention": want_flash}:
            raise AssertionError(f"{what}: prefill launched "
                                 f"{r['prefill_launches']}, want "
                                 f"{want_flash} flash_attention")
        if any(r["decode_launches"].values()):
            raise AssertionError(f"{what}: decode launched a prefill kernel")
        check_decode_launches(r, want_flash, what)
        check_mix_launches(r, 0, what)
        if not r["finite"]:
            raise AssertionError(f"{what}: non-finite logits")


def check_mix_launches(r, layers, what):
    """One ``mix_in`` and one ``mix_out`` a Mamba2 layer a prefill (none
    where the model has no Mamba2 layer)."""
    if r["mix_launches"] != {"mix_in": layers, "mix_out": layers}:
        raise AssertionError(f"{what}: the prefill launched "
                             f"{r['mix_launches']} Mamba2 mix kernels, want "
                             f"{layers} each")


def check_decode_launches(r, layers, what):
    """Every attention layer of every decode step through the decode
    kernel: one call a layer a step."""
    want = layers * r["new_tokens"]
    if r["decode_attention_launches"] != want:
        raise AssertionError(f"{what}: {r['decode_attention_launches']} "
                             f"decode_attention calls in {r['new_tokens']}"
                             f" decode steps, want {want}")


def host_gb():
    """MemAvailable of the host, GB."""
    with open("/proc/meminfo") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("MemAvailable"))
    return kb * 1024 / 1e9


def need_host(cfg, what):
    """Fail before a CPU copy of ``cfg``'s float32 masters that the host
    cannot hold twice (the copy and its transfer)."""
    from repro_torch.models import init_params
    n = sum(p.numel() for p in init_params(cfg, None,
                                           device="meta").parameters())
    free = host_gb()
    log(f"phase 14: {what}: {n} parameters, {4 * n / 1e9:.1f} GB of float32"
        f" masters on the host; {free:.1f} GB available")
    if free < 2 * 4 * n / 1e9:
        raise AssertionError(f"{what}: the host has {free:.1f} GB, needs "
                             f"{2 * 4 * n / 1e9:.1f}")


def olmoe_serving(rec_flash):
    """14 (a): olmoe-1b-7b at full width and depth through ``serve_demo``'s
    loop, the profile of one 4 x 2048 prefill, and one MoE block twice on
    the card, bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import init_params
    from repro_torch.models.moe import moe_block_local
    cfg = get_config(OLMOE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 14: {OLMOE} init_params on the card: {n_params} parameters "
        f"in {time.perf_counter() - t0:.2f} s")
    serve(model, cfg, ((1, 256),), 2, seed=99)  # warm-up, not counted
    for o in (sops, fops, dops):
        o.reset_launches()
    with rec_flash:
        records = serve(model, cfg, SERVE_BATCHES, NEW_TOKENS, seed=0)
    launches = {"ssd": sops.LAUNCHES["ssd"],
                "flash_attention": fops.LAUNCHES["flash_attention"],
                "decode_attention": dops.LAUNCHES["decode_attention"]}
    check_served(records, cfg.n_layers, OLMOE)
    records[0]["prefill_warm"] = warm_prefill(model, cfg, *SERVE_BATCHES[0])
    _, prof = profile_call(prefill_call(model, cfg, *SERVE_BATCHES[0]))
    prof_decode = decode_side_by_side(model, cfg, *OLMOE_DECODE)
    # the combine has no atomics: one block twice at the prefill's shape
    blk = model.blocks[0].moe
    x = torch.randn((*SERVE_BATCHES[0], cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)
                    ).to(torch.bfloat16)
    with torch.no_grad():
        runs = [moe_block_local(x, blk.router, blk.w_gate, blk.w_up,
                                blk.w_down, topk=cfg.topk,
                                capacity_factor=cfg.capacity_factor)
                for _ in range(2)]
    bitwise = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    if not bitwise:
        raise AssertionError(f"{OLMOE}: two MoE block calls differ")
    del model, runs, x
    torch.cuda.empty_cache()
    return {"params": n_params, "records": records, "launches": launches,
            "profile": prof, "profile_decode": prof_decode,
            "block_bitwise": bitwise}


def decode_side_by_side(model, cfg, Bsz, S, cap, steps=8):
    """``steps`` greedy decode steps after a ``Bsz`` x ``S`` prefill with
    capacity ``cap``, profiled (``profile_call``) eagerly
    (``models.decode_step``) and through ``make_decode_step``'s graph
    (captured and replayed once before, on a copy of the cache), each
    from the prefill's cache; each record gains ``ms_per_step``."""
    from repro_torch.models import decode_step
    from repro_torch.runtime import make_decode_step, make_prefill_step
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (Bsz, S)), dtype=torch.int32, device="cuda")
    logits, cache = make_prefill_step(cfg, capacity=cap)(
        model, {"tokens": toks})
    first = logits[:, -1].argmax(-1)
    del logits

    def run(step, cache):
        tok = first
        for t in range(steps):
            pos = torch.full((Bsz,), S + t, dtype=torch.int32, device="cuda")
            out, cache = step(model, {"tokens": tok}, cache, pos)
            tok = out[:, -1].argmax(-1)
        return tok

    graphed = make_decode_step(cfg)
    run(graphed, {k: v.clone() for k, v in cache.items()})  # capture
    tok_graph, graph = profile_call(lambda: run(
        graphed, {k: v.clone() for k, v in cache.items()}))
    del graphed
    tok_eager, eager = profile_call(lambda: run(
        lambda m, b, c, p: decode_step(m, cfg, b, c, p), cache))
    out = {"shape": [Bsz, S, cap], "steps": steps,
           "same_tokens": bool(torch.equal(tok_graph, tok_eager))}
    for name, prof in (("eager", eager), ("graph", graph)):
        prof["ms_per_step"] = prof["wall_ms"] / steps
        out[name] = prof
    del cache
    torch.cuda.empty_cache()
    return out


def olmoe_card_vs_cpu(seed=1, S=300, steps=4):
    """14 (b): olmoe at full width cut to 2 layers, B = 1, S = 300, 4
    decode steps, card against CPU: f32 routing identical at every routing
    call, logits and caches at phase 9's rule; one bf16 MoE block on
    identical inputs (routing identical, output at phase 9's bf16 rule);
    the bf16 model's routing agreement (printed, not held: its upstream
    activations differ by rounding); one f32 train_step at the config's
    own remat "full" at phase 13 (b)'s rule."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_block_local
    out = {}
    for dtype_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(OLMOE), n_layers=2,
                                  dtype=dtype_name)
        card, cpu = card_and_cpu(cfg, seed)
        rng = np.random.default_rng(seed)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                               dtype=torch.int32)
        feeds = torch.as_tensor(rng.integers(0, cfg.vocab, (steps, 1)),
                                dtype=torch.int32)
        routes = {"cuda": Routes(), "cpu": Routes()}
        pairs = serve_both(cfg, card, cpu, {"tokens": toks},
                           [{"tokens": f} for f in feeds], S, routes)
        seen = {d: r.seen for d, r in routes.items()}
        n_calls = cfg.n_layers * (1 + steps)
        if len(seen["cuda"]) != n_calls or len(seen["cpu"]) != n_calls:
            raise AssertionError(f"{len(seen['cuda'])} / {len(seen['cpu'])}"
                                 f" routings, want {n_calls}")
        agreement = routing_agreement(seen["cuda"], seen["cpu"], cfg.topk)
        if dtype_name == "float32":
            for i, (a, b) in enumerate(zip(seen["cuda"], seen["cpu"])):
                if not same_routing(a, b):
                    raise AssertionError(f"{OLMOE} f32 routing call {i} "
                                         f"differs card vs cpu")
            out["float32"] = {"worst": hold_pairs(pairs, dtype_name),
                              "routing": agreement}
            del card, cpu
            continue
        # bf16: routing is held on identical inputs, one block
        diff = max(float((a - b).abs().max()) for what, a, b in pairs
                   if what.startswith("logits"))
        out["bfloat16 model"] = {"routing": agreement,
                                 "logits_max_abs_diff": diff}
        x = torch.as_tensor(rng.standard_normal((1, S, cfg.d_model)),
                            dtype=torch.float32).to(torch.bfloat16)
        ys, block_routes = {}, {}
        for dev, model in (("cuda", card), ("cpu", cpu)):
            blk = model.blocks[0].moe
            with Routes() as r, torch.no_grad():
                ys[dev] = moe_block_local(
                    x.to(dev), blk.router, blk.w_gate, blk.w_up, blk.w_down,
                    topk=cfg.topk, capacity_factor=cfg.capacity_factor)[0]
            block_routes[dev], = r.seen
        if not same_routing(block_routes["cuda"], block_routes["cpu"]):
            raise AssertionError(f"{OLMOE} bf16 block routing differs card "
                                 f"vs cpu on identical inputs")
        out["bfloat16 block"] = hold_pairs(
            [("moe y", ys["cuda"].float().cpu(), ys["cpu"].float())],
            dtype_name)
        del card, cpu
    cfg = dataclasses.replace(get_config(OLMOE), n_layers=2,
                              dtype="float32")
    if cfg.remat != "full":
        raise AssertionError(f"{OLMOE}'s config remats {cfg.remat!r}")
    out["train_step float32"] = train_card_vs_cpu("float32", seed=seed, S=S,
                                                  cfg=cfg)[0]
    torch.cuda.empty_cache()
    return out


def vlm_serving(rec_flash, seed=1, S=256, steps=2):
    """14 (c): qwen2-vl-72b at full width cut to ``VLM_LAYERS`` layers:
    ``serve_demo``'s vlm feed on an image grid; then 1 layer card against
    CPU in f32 (prefill of embeds on the grid, decode fed embeds)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(QWEN_VL), n_layers=VLM_LAYERS)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    feed = grid_feed(cfg)
    serve(model, cfg, ((1, 256),), 2, seed=99, feed=feed)  # warm-up
    for o in (sops, fops):
        o.reset_launches()
    with rec_flash:
        records = serve(model, cfg, VLM_BATCHES, VLM_NEW_TOKENS, seed=0,
                        feed=feed)
    launches = {"ssd": sops.LAUNCHES["ssd"],
                "flash_attention": fops.LAUNCHES["flash_attention"]}
    check_served(records, cfg.n_layers, QWEN_VL)
    records[0]["prefill_warm"] = warm_prefill(model, cfg, *VLM_BATCHES[0],
                                              feed=feed)
    del model
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    need_host(cfg, f"{QWEN_VL} 1 layer card vs cpu")
    card, cpu = card_and_cpu(cfg, seed)
    rng = np.random.default_rng(seed)
    prompt = {k: v.cpu() for k, v in grid_feed(cfg)(rng, 1, S).items()}
    feeds = [{"embeds": torch.as_tensor(
        rng.standard_normal((1, 1, cfg.d_model)), dtype=torch.float32)}
        for _ in range(steps)]
    worst = hold_pairs(serve_both(cfg, card, cpu, prompt, feeds, S),
                       "float32")
    del card, cpu
    torch.cuda.empty_cache()
    return {"params": n_params, "records": records, "launches": launches,
            "card_vs_cpu": worst}


def audio_encode(rec_flash, seed=1, S=300):
    """14 (d): hubert-xlarge at full width and depth through
    ``step_fn_for(cfg, "encode")`` over 4 x 1500 frames; then 6 layers
    card against CPU, f32 and bf16."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import init_params
    from repro_torch.runtime import step_fn_for
    cfg = get_config(HUBERT)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    encode = step_fn_for(cfg, "encode")
    rng = np.random.default_rng(0)

    def embeds(Bsz, frames):
        return {"embeds": torch.as_tensor(
            rng.standard_normal((Bsz, frames, cfg.d_model)),
            dtype=torch.float32, device="cuda")}
    batch = embeds(*AUDIO_BATCH)
    encode(model, batch)  # warm-up at the timed shape, not counted
    secs = []
    for _ in range(3):
        for o in (sops, fops):
            o.reset_launches()
        logits = None
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        with rec_flash:
            t0 = time.perf_counter()
            logits = encode(model, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        memory = step_memory(allocated, tensor_bytes(model, batch))
        launches = {"ssd": sops.LAUNCHES["ssd"],
                    "flash_attention": fops.LAUNCHES["flash_attention"]}
        if launches != {"ssd": 0, "flash_attention": cfg.n_layers}:
            raise AssertionError(f"{HUBERT} encode launched {launches}")
        if logits.shape != (*AUDIO_BATCH, cfg.vocab) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{HUBERT} encode logits {logits.shape}")
    median = float(np.median(secs))
    rec = {"params": n_params, "batch": AUDIO_BATCH, "encode_s": median,
           "encode_s_runs": secs,
           "frames_per_s": AUDIO_BATCH[0] * AUDIO_BATCH[1] / median,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "encode_memory": memory}
    del model, logits, batch
    torch.cuda.empty_cache()
    for dtype_name in ("float32", "bfloat16"):
        small = dataclasses.replace(cfg, n_layers=AUDIO_CHECK_LAYERS,
                                    dtype=dtype_name)
        card, cpu = card_and_cpu(small, seed)
        x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
            (1, S, cfg.d_model)), dtype=torch.float32)
        step = step_fn_for(small, "encode")
        got = step(card, {"embeds": x.cuda()}).cpu()
        want = step(cpu, {"embeds": x})
        rec[f"card_vs_cpu {dtype_name}"] = hold_pairs(
            [("encode logits", got, want)], dtype_name)
        del card, cpu
    return rec


def family_flash_timings(shapes, launches, err):
    """14 (e): ``flash_attention`` against its plain version at every shape
    (a), (c) and (d) launched (bf16, the tests' 2e-2), then timed there
    beside the plain version, its bound and ``scaled_dot_product_attention``
    with the same causality (``lm_kernel_timings``' method)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fops
    flash, _ = phase_shape_cases(set(), shapes)
    check_lm_kernels(flash, [], err)
    out = []
    for name, (q, k, v, causal, window) in flash:
        Bsz, S, H, hd = q.shape
        K = k.shape[2]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fops.flash_attention(q, k, v, causal=causal,
                                                  window=window))
        plain_ms = time_ms(lambda: fops.ref.flash_attention(
            q, k, v, causal=causal, window=window), reps=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=H != K))
        # each input read once, the output written once; q.k and p.v over
        # the pairs the mask keeps (causal: the kernel skips tiles above
        # the frontier): the operator's FLOP rule
        nbytes = fops.io_bytes(Bsz, S, S, H, K, hd, 2)
        nops = fops.flops(Bsz, S, S, H, hd, causal, window)
        bound_ms, bound_by = _bound(nbytes, nops)
        out.append({"shape": [Bsz, S, S, H, K, hd], "causal": causal,
                    "path": launches[(Bsz, S, H, K, hd, causal)], "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bytes": nbytes, "ops": nops})
        del q, k, v, qt, kt, vt
    return out


def families(kernels, err):
    """Phase 14 (see the module docstring); adds the per-shape times to the
    ``flash_attention`` record of ``kernels``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    rec_flash = ShapeRecorder(fops, "flash_attention", lambda q, k, v, **kw: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
        q.shape[3], kw.get("causal"), kw.get("window"), q.dtype))
    t0 = time.perf_counter()
    a = olmoe_serving(rec_flash)
    for r in a["records"]:
        d = r["moe_dropped_frac"]
        log(f"phase 14: {OLMOE} {r['requests']} x {r['prompt']} tokens: "
            f"prefill {r['prefill_s']:.4f} s, decode {r['new_tokens']} "
            f"tokens in {r['decode_s']:.4f} s = {r['decode_tok_per_s']:.1f} "
            f"tokens/s, peak {r['peak_gb']:.2f} GB; moe_dropped_frac mean "
            f"{sum(d) / len(d):.4f} (layers {min(d):.4f}-{max(d):.4f}); "
            f"launches per prefill {r['prefill_launches']}, in decode "
            f"{r['decode_launches']}; logits finite")
    log(f"phase 14: {OLMOE} main-path launches {a['launches']}; one MoE "
        f"block twice at {SERVE_BATCHES[0]} bf16: bitwise equal; prefill "
        f"profile " + json.dumps(a["profile"]))
    log(f"phase 14: {OLMOE} decode steps, eager and graphed " + json.dumps(
        a["profile_decode"]))
    b = olmoe_card_vs_cpu()
    log(f"phase 14: {OLMOE} 2 layers card == cpu: f32 routing identical at "
        f"every call ({b['float32']['routing']['tokens']} token routings), "
        f"logits and caches max abs diff "
        f"{max(d for d, _, _ in b['float32']['worst'].values()):.3g}; bf16 "
        f"block on identical inputs: routing identical, y "
        f"{b['bfloat16 block']['moe y']}; bf16 model routing "
        f"{b['bfloat16 model']['routing']}, logits max abs diff (not held) "
        f"{b['bfloat16 model']['logits_max_abs_diff']:.3g}; f32 train_step "
        f"(remat full) loss (diff, value, rel) "
        f"{b['train_step float32']['loss']}, max abs diff over the "
        f"gradients and parameters "
        f"{max(d for d, _, _ in b['train_step float32'].values()):.3g}")
    c = vlm_serving(rec_flash)
    for r in c["records"]:
        log(f"phase 14: {QWEN_VL} {VLM_LAYERS} layers, {r['requests']} x "
            f"{r['prompt']} embeds on a {VLM_GRID_WIDTH}-wide grid: prefill "
            f"{r['prefill_s']:.4f} s, decode {r['new_tokens']} tokens in "
            f"{r['decode_s']:.4f} s = {r['decode_tok_per_s']:.1f} tokens/s,"
            f" peak {r['peak_gb']:.2f} GB; launches per prefill "
            f"{r['prefill_launches']}; logits finite")
    log(f"phase 14: {QWEN_VL} 1 layer f32 card == cpu, max abs diff "
        f"{max(d for d, _, _ in c['card_vs_cpu'].values()):.3g} "
        + json.dumps(c["card_vs_cpu"]))
    d = audio_encode(rec_flash)
    log(f"phase 14: {HUBERT} encode {d['batch'][0]} x {d['batch'][1]} frames"
        f" in {d['encode_s']:.4f} s (median of "
        f"{[round(x, 4) for x in d['encode_s_runs']]}) = "
        f"{d['frames_per_s']:.1f} frames/s, "
        f"peak {d['peak_gb']:.2f} GB, launches {d['launches']}; "
        f"{AUDIO_CHECK_LAYERS} layers card == cpu f32 "
        f"{d['card_vs_cpu float32']}, bf16 {d['card_vs_cpu bfloat16']}")
    # the path and launches behind each shape, keyed as the cases' shapes
    paths = {}
    for arch, batches, per in ((OLMOE, a["records"], "prefill"),
                               (QWEN_VL, c["records"], "prefill"),
                               (HUBERT, [d], "encode")):
        cfg = get_config(arch)
        for r in batches:
            Bsz, S = (r["requests"], r["prompt"]) if per == "prefill" \
                else r["batch"]
            n = r["prefill_launches"] if per == "prefill" else r["launches"]
            paths[(Bsz, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                   cfg.causal)] = {"model": arch, f"launches_per_{per}":
                                   n["flash_attention"]}
    timed = family_flash_timings(set(rec_flash.seen), paths, err)
    for e in timed:
        log(f"phase 14: flash_attention {e['shape']} causal={e['causal']} "
            f"({e['path']['model']}): {e['ms']:.4f} ms (plain "
            f"{e['plain_ms']:.4f}, library {e['library_ms']:.4f}, bound "
            f"{e['bound_ms']:.4f} by {e['bound_by']}); == plain")
    record = next(k for k in kernels if k["name"] == "flash_attention")
    record["families"] = timed
    log(f"phase 14: {time.perf_counter() - t0:.1f} s; records " + json.dumps(
        {"olmoe": {k: v for k, v in a.items()
                   if not k.startswith("profile")},
         "olmoe_card_vs_cpu": b, "qwen2_vl": c, "hubert": d}, default=str))
    return {"olmoe": a, "qwen2_vl": c, "hubert": d}


def families_bench():
    """Phase 14 alone on the card (with its builds), for bring-up."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    log(device_line())
    build.build_all([fops.SOURCE])
    kernels = [{"name": "flash_attention"}]
    err = dict.fromkeys(list(REPLACES), 0.0)
    families(kernels, err)
    print(json.dumps({"kernels": kernels}), flush=True)


# ------------------------------------------------------------- phase 15
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun_torch")
# the reference's tiny-mesh trio and two cells of the SSD path (the
# kernels' and the causal conv's local_map forward and backward), on the
# production mesh
PRODUCTION_CELLS = (("qwen3-1.7b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
                    ("mamba2-780m", "long_500k"),
                    ("mamba2-780m", "prefill_32k"),
                    ("zamba2-2.7b", "train_4k"))
PEAK_BAND = 0.20      # predicted peak within 20 % of the card's step peak
BOUND_SLACK = 1.05    # the roofline's bound over the measured time
WARM_HOW = f"phase %s, median of {WARM_RUNS} warm calls"


def one_card_cells(measured):
    """Phase 15 (a)'s cells: the steps the card ran at full width in phases
    8, 13 and 14, each ``(label, arch, cfg, cell, seconds, how, memory)``
    with the card's time and memory record of that step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import ShapeCell
    zamba = get_config(ARCH)
    serve9 = measured["serve"][0]
    train14 = measured["train"]
    olmoe = measured["olmoe"]["records"][0]
    vlm = measured["qwen2_vl"]["records"][0]
    hubert = measured["hubert"]
    return [
        ("zamba2 prefill", ARCH, zamba,
         ShapeCell("prefill_4x2048", "prefill", 2048, 4),
         serve9["prefill_warm"]["median_s"], WARM_HOW % 8,
         serve9["prefill_memory"]),
        ("zamba2 train", ARCH, dataclasses.replace(zamba, remat="none"),
         ShapeCell("train_1x2048", "train", 2048, 1),
         train14["median_step_s"],
         "phase 13 (c), median step on the card's (1, 1) mesh",
         train14["step_memory"]),
        ("olmoe prefill", OLMOE, get_config(OLMOE),
         ShapeCell("prefill_4x2048", "prefill", 2048, 4),
         olmoe["prefill_warm"]["median_s"], WARM_HOW % "14 (a)",
         olmoe["prefill_memory"]),
        ("qwen2-vl prefill", QWEN_VL,
         dataclasses.replace(get_config(QWEN_VL), n_layers=VLM_LAYERS),
         ShapeCell("prefill_2x2048", "prefill", *VLM_BATCHES[0][::-1]),
         vlm["prefill_warm"]["median_s"], WARM_HOW % "14 (c)",
         vlm["prefill_memory"]),
        ("hubert encode", HUBERT, get_config(HUBERT),
         ShapeCell("encode_4x1500", "prefill", *AUDIO_BATCH[::-1]),
         hubert["encode_s"], "phase 14 (d), median of 3",
         hubert["encode_memory"]),
    ]


def dry_run_phase(measured):
    """Phase 15 (see the module docstring)."""
    import logging

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.roofline import roofline_terms
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"phase 15: card memory {total} bytes "
        f"(launch.mesh.HW.HBM_BYTES {HW.HBM_BYTES})")
    out = {"one_card": [], "production": []}
    for label, arch, cfg, cell, secs, how, mem in one_card_cells(measured):
        rec = run_cell(arch, cell, False, out_dir=DRYRUN_OUT,
                       cfg_override=cfg, tag="card", mesh_shape=(1, 1),
                       param_dtype=torch.float32)
        rt = roofline_terms(rec, cfg, cell, measured_s=secs)
        bound = max(rt["compute_s"], rt["memory_s"])
        peak, step_peak = rec["memory"]["peak_bytes"], mem["step_peak_bytes"]
        row = {"cell": label, "arch": arch, "batch": cell.batch,
               "seq": cell.seq, "kind": rec["kind"],
               "flops": rec["flops_per_device"],
               "hbm_bytes": rec["hbm_bytes_per_device"],
               "predicted_peak_bytes": peak,
               "predicted_argument_bytes": rec["memory"]["argument_bytes"],
               "compute_s": rt["compute_s"], "memory_s": rt["memory_s"],
               "bound_s": bound, "measured_s": secs, "measured": how,
               "bound_fraction": bound / secs,
               "model_flops": rt["model_flops"], "mfu": rt["mfu"],
               "card_memory": mem,
               "peak_error": (peak - step_peak) / step_peak,
               "collective": rec["collective"], "trace_s": rec["lower_s"]}
        out["one_card"].append(row)
        log(f"phase 15: {label} {cell.batch} x {cell.seq} ({rec['kind']}, "
            f"float32 masters): predicted {row['flops']:.4e} FLOPs, "
            f"{row['hbm_bytes']:.4e} HBM bytes, compute "
            f"{rt['compute_s'] * 1e3:.3f} ms, memory "
            f"{rt['memory_s'] * 1e3:.3f} ms, peak {peak / 1e9:.3f} GB; "
            f"measured {secs:.4f} s ({how}), step peak "
            f"{step_peak / 1e9:.3f} GB (max_memory_allocated "
            f"{mem['max_allocated_bytes'] / 1e9:.3f} GB); bound / measured "
            f"{row['bound_fraction']:.4f}, peak error "
            f"{row['peak_error']:+.4f}, mfu {rt['mfu']:.4f}")
        if rec["collective"]["total_bytes"] or rec["collective"]["counts"]:
            raise AssertionError(f"{label}: a one-card mesh issued "
                                 f"collectives {rec['collective']}")
        if row["bound_fraction"] > BOUND_SLACK:
            raise AssertionError(f"{label}: the roofline bound {bound:.4f} "
                                 f"s exceeds the measured {secs:.4f} s: a "
                                 f"wrong count")
        if abs(row["peak_error"]) > PEAK_BAND:
            raise AssertionError(
                f"{label}: predicted peak {peak} bytes vs the card's step "
                f"peak {step_peak}: {row['peak_error']:+.3f}")
    t1 = time.perf_counter()
    for arch, shape in PRODUCTION_CELLS:
        from repro_torch.configs import get_config
        rec = run_cell(arch, shape, False, out_dir=DRYRUN_OUT)
        if rec["status"] != "ok":
            raise AssertionError(f"{arch} x {shape}: {rec}")
        rt = roofline_terms(rec, get_config(arch), shape)
        out["production"].append({"arch": arch, "shape": shape,
                                  "mesh": rec["mesh"], **rt,
                                  "trace_s": rec["lower_s"]})
        log(f"phase 15: {arch} x {shape} on {rec['mesh']}: "
            f"{rt['peak_bytes_per_device'] / 2**30:.3f} GiB a device, fits "
            f"{rt['fits_hbm']}; {rt['flops_per_device']:.4e} FLOPs a "
            f"device; collective bytes by op "
            f"{json.dumps(rt['collective_per_op'])}; compute "
            f"{rt['compute_s'] * 1e3:.3f} ms, memory "
            f"{rt['memory_s'] * 1e3:.3f} ms, collective "
            f"{rt['collective_s'] * 1e3:.3f} ms: {rt['dominant']}-bound")
    prod_s = time.perf_counter() - t1
    log(f"phase 15: production cells {prod_s:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s; records " + json.dumps(out))
    return out


def step_times():
    """Two end-to-end steps through the ``repro_torch`` first on
    ``sys.path`` (its kernels built in its own checkout): olmoe-1b-7b's
    4 x 2048 prefill as phase 14 (a) serves it (after a 1 x 256 warm-up;
    the first call at that shape, then ``warm_prefill``) and zamba2-2.7b's
    1 x 2048 training steps as phase 13 (c) runs them.  Prints one line,
    ``STEP_TIMES {...}``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    build.build_all([sops.SOURCE, fops.SOURCE])
    cfg = get_config(OLMOE)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    serve(model, cfg, ((1, 256),), 2, seed=99)
    first = serve(model, cfg, SERVE_BATCHES[:1], NEW_TOKENS, seed=0)[0]
    warm = warm_prefill(model, cfg, *SERVE_BATCHES[0])
    del model
    torch.cuda.empty_cache()
    out = train(ARCH, smoke=False, seq=2048, batch=1, steps=8, monitor=True,
                log_every=1)
    print("STEP_TIMES " + json.dumps({
        "tree": os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))),
        "olmoe_prefill_first_s": first["prefill_s"],
        "olmoe_prefill_warm": warm, "zamba2_train_step_s": out["step_s"],
        "zamba2_train_median_s": float(np.median(out["step_s"][1:]))}),
        flush=True)


def step_ab(parent):
    """``step_times`` of the checkout at ``parent`` and of this one in four
    processes, parent, this, this, parent, on one card:

      git archive <parent commit> | tar -x -C build/ab_parent
      python3 -c "import chip_smoke; chip_smoke.step_ab('build/ab_parent')"
    """
    parent = os.path.abspath(parent)
    log(device_line())
    recs = []
    for tree in (parent, ROOT, ROOT, parent):
        code = (f"import sys; sys.path[:0] = "
                f"[{os.path.join(tree, 'src')!r}, {ROOT!r}]; "
                f"import chip_smoke; chip_smoke.step_times()")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=900, cwd=ROOT)
        got = [x for x in r.stdout.splitlines() if x.startswith("STEP_TIMES ")]
        if r.returncode or not got:
            raise RuntimeError(f"step_times in {tree}: rc {r.returncode}\n"
                               f"{r.stderr[-3000:]}")
        recs.append(json.loads(got[-1][len("STEP_TIMES "):]))
        rec = recs[-1]
        log(f"{rec['tree']}: olmoe prefill 4 x 2048 first "
            f"{rec['olmoe_prefill_first_s']:.4f} s, warm median "
            f"{rec['olmoe_prefill_warm']['median_s']:.4f} s "
            f"{rec['olmoe_prefill_warm']['runs_s']}; zamba2 train step "
            f"median {rec['zamba2_train_median_s']:.4f} s "
            f"{rec['zamba2_train_step_s']}")
    print(json.dumps({"step_ab": recs}), flush=True)


# ------------------------------------------------------------- phase 16
# (B, cap) of the olmoe cells' decode (perfbench/traffic: the decode cell's
# caps S + 256 at 32 requests, the prefill cell's longest S + 13 at 8)
DECODE_TIMED = ((32, 1792), (32, 960), (8, 3853))
DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}  # sum order only


def host_us(fn, calls=50):
    """Host microseconds a call of ``fn``: ``calls`` calls issued behind a
    device sleep, so the host never waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def decode_attention_phase(err, launches=None):
    """Phase 16 (see the module docstring): the ``decode_attention``
    record; ``launches`` is the main path's count (phase 14's olmoe
    serve), the timing loop's own calls go under ``timed_launches``.
    Beside the kernel, SDPA with an explicit mask on transposed copies
    (``library_ms``), and a layer's whole route both ways on the caches in
    place (this token's write, then attention): the kernel's one call
    (``route_ms``, ``route_host_us``) against ``append_kv``, the mask and
    SDPA on strided views of the cache (``library_route_ms``,
    ``library_route_host_us``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.models.attention import append_kv
    t0 = time.perf_counter()
    cases = []
    for B, cap in DECODE_TIMED:
        H = K = 16
        hd = 128
        args = dops.ref.case(B + cap, B, cap, H, K, hd, "full",
                             torch.bfloat16, "cuda")
        q, k, v, kvpos, pos = args
        before = dops.LAUNCHES["decode_attention"]
        ms = time_ms(lambda: dops.decode_attention(*args))
        launched = dops.LAUNCHES["decode_attention"] - before
        plain_ms = time_ms(lambda: dops.ref.decode_attention(*args), reps=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = ((kvpos >= 0) & (kvpos <= pos[:, None]))[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != K))
        kn, vn = torch.randn((2, B, 1, K, hd), device="cuda").to(q.dtype)

        def route():
            return dops.decode_attention(q, k, v, kvpos, pos, k_new=kn,
                                         v_new=vn)

        def library_route():
            append_kv(k, v, kn, vn, pos)
            m = ((kvpos >= 0) & (kvpos <= pos[:, None]))[:, None, None, :]
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, enable_gqa=H != K).transpose(1, 2)

        routes = {"route_ms": time_ms(route),
                  "library_route_ms": time_ms(library_route),
                  "route_host_us": host_us(route),
                  "library_route_host_us": host_us(library_route)}
        nbytes = dops.io_bytes(B, cap, H, K, hd, 2)
        nops = dops.flops(B, H, cap, hd)
        bound_ms, bound_by = _bound(nbytes, nops)
        split = dops.plan(B, K, H // K, cap, torch.cuda.get_device_properties(
            0).multi_processor_count)
        cases.append({"shape": [B, cap, H, K, hd], "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bytes": nbytes, "ops": nops, "split_len": split,
                      "n_split": -(-cap // split),
                      "timed_launches": launched, **routes})
        log(f"phase 16: decode_attention B {B} cap {cap} G 1 hd 128 bf16: "
            f"{ms:.4f} ms (plain {plain_ms:.4f}, library {lib_ms:.4f}, "
            f"bound {bound_ms:.4f} by {bound_by}, {bound_ms / ms:.1%} of "
            f"it; {-(-cap // split)} splits of {split}); a layer's write + "
            f"attention: kernel {routes['route_ms']:.4f} ms, host "
            f"{routes['route_host_us']:.1f} us; append_kv + mask + SDPA on "
            f"the cache's views {routes['library_route_ms']:.4f} ms, host "
            f"{routes['library_route_host_us']:.1f} us")
        del args, q, k, v, qt, kt, vt, kn, vn
    first = cases[0]
    entry = _entry("decode_attention", {"decode_attention": launches}, err,
        first["ms"], first["plain_ms"],
        first["library_ms"], first["bytes"], first["ops"],
        "olmoe decode, q (32, 1, 16, 128), caches (32, 1792, 16, 128) bf16",
        cases=cases)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return [entry]


def decode_attention_bench():
    """Phase 16 alone on the card, with its build."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as dops
    log(device_line())
    path, secs = build.build_all([dops.SOURCE])["decode_attention"]
    log(f"phase 16: built {os.path.relpath(path, ROOT)} in {secs:.2f} s; "
        f"registers and [spill store, spill load] bytes: " + json.dumps(
            kernel_report(dops.SOURCE, path, keep=lambda name: "kernel"
                          in name)))
    err = {}
    print(json.dumps({"kernels": decode_attention_phase(err)}), flush=True)


# ------------------------------------------------------------- phase 17
ZYPHRA = "zamba2-2.7b-zyphra"
# the zamba2-2.7b-serve-prefill cell's shapes (perfbench's azure-code mix:
# 8 clients, prompts of 768 to 3840 tokens, 13 tokens served a prompt)
ZYPHRA_B = 8
ZYPHRA_PROMPTS = (768, 1536, 3840)
ZYPHRA_CAP = 3840 + 13
ZYPHRA_NEW_TOKENS = 4


def zyphra_serving():
    """17 (a): Zyphra's form served at full width, launches counted and
    every attention call's softmax scale recorded."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import init_params
    cfg = get_config(ZYPHRA)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    serve(model, cfg, ((1, 256),), 2, seed=99)  # warm-up, not counted
    for o in (sops, fops, dops):
        o.reset_launches()
    flash = ShapeRecorder(fops, "flash_attention", lambda q, k, v, **kw: (
        tuple(q.shape), kw.get("scale")))
    decode = ShapeRecorder(dops, "decode_attention", lambda q, k, *a, **kw: (
        tuple(q.shape), tuple(k.shape), kw.get("scale")))
    with flash, decode:
        records = serve(model, cfg, ((ZYPHRA_B, ZYPHRA_PROMPTS[-1]),
                                     (ZYPHRA_B, ZYPHRA_PROMPTS[0])),
                        ZYPHRA_NEW_TOKENS, seed=0)
    uses = len(cfg.hybrid_layer_ids)
    for r in records:
        if r["prefill_launches"] != {"ssd": cfg.n_layers,
                                     "flash_attention": uses}:
            raise AssertionError(f"{ZYPHRA}: prefill launched "
                                 f"{r['prefill_launches']}, want "
                                 f"{cfg.n_layers} ssd and {uses} "
                                 f"flash_attention")
        if any(r["decode_launches"].values()):
            raise AssertionError(f"{ZYPHRA}: decode launched a prefill "
                                 f"kernel")
        check_decode_launches(r, uses, ZYPHRA)
        check_mix_launches(r, cfg.n_layers, ZYPHRA)
        if not r["finite"]:
            raise AssertionError(f"{ZYPHRA}: non-finite logits")
    scales = {key[-1] for key in flash.seen | decode.seen}
    if scales != {cfg.attn_scale}:
        raise AssertionError(f"{ZYPHRA}: attention scales {scales}, want "
                             f"{cfg.attn_scale}")
    prof_decode = decode_side_by_side(model, cfg, ZYPHRA_B,
                                      ZYPHRA_PROMPTS[-1], ZYPHRA_CAP)
    del model
    torch.cuda.empty_cache()
    return cfg, {"records": records,
                 "launches": {"ssd": sops.LAUNCHES["ssd"],
                              "flash_attention":
                                  fops.LAUNCHES["flash_attention"],
                              "decode_attention":
                                  dops.LAUNCHES["decode_attention"]},
                 "flash_calls": sorted(map(str, flash.seen)),
                 "decode_calls": sorted(map(str, decode.seen)),
                 "profile_decode": prof_decode}


def zyphra_flash(cfg, err):
    """17 (b): the bf16 hd-160 forward against its plain version (a batch
    row at a time: the dense scores of 8 rows at 3840 would not fit) at
    the cell's prefill shapes and Zyphra's scale, then timed beside the
    plain version, its bound and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fops
    H, K, hd, scale = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.attn_scale
    rng = np.random.default_rng(18)
    out = []
    for S in ZYPHRA_PROMPTS:
        q, k, v, _, _ = flash_case(rng, ZYPHRA_B, S, S, H, K, hd,
                                   torch.bfloat16)

        def kernel():
            return fops.flash_attention(q, k, v, causal=True, scale=scale)

        def plain():
            return [fops.ref.flash_attention(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True,
                scale=scale) for i in range(ZYPHRA_B)]

        _close(kernel(), torch.cat(plain()), FLASH_TOL[torch.bfloat16],
               f"flash_attention {ZYPHRA} {(ZYPHRA_B, S, H, K, hd)}", err,
               "flash_attention")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale))
        nbytes = fops.io_bytes(ZYPHRA_B, S, S, H, K, hd, 2)
        nops = fops.flops(ZYPHRA_B, S, S, H, hd, True, None)
        bound_ms, bound_by = _bound(nbytes, nops)
        out.append({"shape": [ZYPHRA_B, S, S, H, K, hd], "causal": True,
                    "scale": scale, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "ops": nops})
        del q, k, v, qt, kt, vt
    return out


def zyphra_decode(cfg, err):
    """17 (c): the decode kernel at hd 160 against its plain version at the
    cell's longest cache and Zyphra's scale (every slot valid, and rows
    part filled), then timed there beside the plain version, its bound
    (``ops.io_bytes``) and SDPA with an explicit mask on transposed
    copies."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as dops
    H, K, hd, scale = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.attn_scale
    B, cap = ZYPHRA_B, ZYPHRA_CAP
    for seed, kind in enumerate(("full", "fill")):
        args = dops.ref.case(seed, B, cap, H, K, hd, kind, torch.bfloat16,
                             "cuda")
        _close(dops.decode_attention(*args, scale=scale).float(),
               dops.ref.decode_attention(*args, scale=scale).float(),
               (DECODE_TOL[torch.bfloat16],) * 2,
               f"decode_attention {ZYPHRA} {(B, cap, H, K, hd, kind)}", err,
               "decode_attention")
    q, k, v, kvpos, pos = args = dops.ref.case(
        2, B, cap, H, K, hd, "full", torch.bfloat16, "cuda")
    ms = time_ms(lambda: dops.decode_attention(*args, scale=scale))
    plain_ms = time_ms(lambda: dops.ref.decode_attention(*args, scale=scale),
                       reps=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = ((kvpos >= 0) & (kvpos <= pos[:, None]))[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale))
    nbytes = dops.io_bytes(B, cap, H, K, hd, 2)
    nops = dops.flops(B, H, cap, hd)
    bound_ms, bound_by = _bound(nbytes, nops)
    return {"shape": [B, cap, H, K, hd], "scale": scale, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": nops}


def zyphra_phase(kernels, err):
    """Phase 17 (see the module docstring): adds a ``zyphra`` field to the
    ``flash_attention`` and ``decode_attention`` records of ``kernels``."""
    t0 = time.perf_counter()
    cfg, a = zyphra_serving()
    for r in a["records"]:
        log(f"phase 17: {ZYPHRA} {r['requests']} x {r['prompt']} tokens: "
            f"prefill {r['prefill_s']:.4f} s, decode {r['new_tokens']} "
            f"tokens in {r['decode_s']:.4f} s, peak {r['peak_gb']:.2f} GB; "
            f"launches per prefill {r['prefill_launches']}, decode_attention"
            f" in decode {r['decode_attention_launches']}; logits finite")
    log(f"phase 17: {ZYPHRA} main-path launches {a['launches']}; every "
        f"attention call at scale {cfg.attn_scale}: flash_attention "
        f"{a['flash_calls']}, decode_attention {a['decode_calls']}")
    log(f"phase 17: {ZYPHRA} decode steps, eager and graphed "
        + json.dumps(a["profile_decode"]))
    flash = zyphra_flash(cfg, err)
    for e in flash:
        log(f"phase 17: flash_attention {e['shape']} scale {e['scale']:.6g}:"
            f" {e['ms']:.4f} ms (plain {e['plain_ms']:.4f}, library "
            f"{e['library_ms']:.4f}, bound {e['bound_ms']:.4f} by "
            f"{e['bound_by']}, {e['bound_ms'] / e['ms']:.1%} of it); == "
            f"plain")
    dec = zyphra_decode(cfg, err)
    log(f"phase 17: decode_attention {dec['shape']} scale "
        f"{dec['scale']:.6g}: {dec['ms']:.4f} ms (plain "
        f"{dec['plain_ms']:.4f}, library {dec['library_ms']:.4f}, bound "
        f"{dec['bound_ms']:.4f} by {dec['bound_by']}, "
        f"{dec['bound_ms'] / dec['ms']:.1%} of it); == plain, full and "
        f"part-filled rows")
    r = a["records"][0]
    for k in kernels:
        if k["name"] == "flash_attention":
            k["zyphra"] = {"launches_per_prefill":
                           r["prefill_launches"]["flash_attention"],
                           "cases": flash}
        elif k["name"] == "decode_attention":
            k["zyphra"] = {"launches_per_step":
                           r["decode_attention_launches"] // r["new_tokens"],
                           **dec}
    log(f"phase 17: {time.perf_counter() - t0:.1f} s; records "
        + json.dumps(a["records"]))


def zyphra_bench():
    """Phase 17 alone on the card, with its builds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    log(device_line())
    build.build_all([sops.SOURCE, fops.SOURCE, dops.SOURCE])
    kernels = [{"name": "flash_attention"}, {"name": "decode_attention"}]
    err = {}
    zyphra_phase(kernels, err)
    print(json.dumps({"kernels": kernels}), flush=True)


# ------------------------------------------------------------- phase 18
MIX_PROMPTS = ZYPHRA_PROMPTS   # B 8 x these: the zamba2 cell's prefills
SPLIT_RUNS = 3                 # warm prefills a shape in the split


def mix_kernels(cfg):
    """18 (a): ``mix_in`` and ``mix_out`` timed at the cell's prefill shapes
    beside their byte bound and the plain route (the ``cuda`` tests hold
    them to the plain route at these shapes)."""
    from repro_torch.kernels.mamba2_mix import ops as mops
    din, H, G, N = (cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups,
                    cfg.ssm_state)
    out = {"mamba2_mix_in": [], "mamba2_mix_out": []}
    for S in MIX_PROMPTS:
        B = ZYPHRA_B
        p, zx, Y = mops.ref.case(cfg, B, S, torch.bfloat16, "cuda", seed=S)
        args_in = (zx, p.conv_w, p.conv_b, p.dt_bias, p.A_log, din, G, N)
        args_out = (Y, zx, p.conv_w, p.conv_b, p.D, p.norm_scale,
                    cfg.norm_eps)
        with torch.no_grad():
            x = mops.ref.mix_in(*args_in)[4]
            for name, kernel, plain in (
                    ("mamba2_mix_in", lambda: mops.mix_in(*args_in),
                     lambda: mops.ref.mix_in(*args_in)),
                    ("mamba2_mix_out", lambda: mops.mix_out(*args_out),
                     lambda: mops.ref.mix_out(Y, zx, x, p.D, p.norm_scale,
                                              cfg.norm_eps))):
                ms = time_ms(kernel)
                plain_ms = time_ms(plain, reps=5)
                nbytes = mops.io_bytes(B, S, din, H, G, N, name[7:])
                bound_ms, bound_by = _bound(nbytes, 0)
                out[name].append({
                    "shape": [B, S, din, H, G, N], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes})
        del zx, p, Y, x
        torch.cuda.empty_cache()
    return out


def neighbours(cfg):
    """18 (c): the scan and the hd-160 flash at 8 x 3840 timed alone (CUDA
    events around each call, no L2 flush, the median of 15) right after
    ``mix_out``'s kernel, right after the plain ``mix_out`` passes and
    right after a spin of the card (its SMs idle), to see whether their
    neighbours slow them."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    din, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    S = MIX_PROMPTS[-1]
    p, zx, Y = mops.ref.case(cfg, ZYPHRA_B, S, torch.bfloat16, "cuda",
                             seed=19)
    out = {}
    with torch.no_grad():
        X, Adt, Bm, Cm = mops.mix_in(zx, p.conv_w, p.conv_b, p.dt_bias,
                                     p.A_log, din, G, N)
        x = mops.ref.conv_x(zx, p.conv_w, p.conv_b, cfg.ssm_heads)
        q, k, v, _, _ = flash_case(np.random.default_rng(19), ZYPHRA_B, S, S,
                                   cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                   torch.bfloat16)
        before = {
            "after_mix_out_kernel": lambda: mops.mix_out(
                Y, zx, p.conv_w, p.conv_b, p.D, p.norm_scale, cfg.norm_eps),
            "after_plain_mix_out": lambda: mops.ref.mix_out(
                Y, zx, x, p.D, p.norm_scale, cfg.norm_eps),
            "after_spin": lambda: torch.cuda._sleep(4_000_000)}
        targets = {
            "ssd": lambda: sops.ssd(X, Adt, Bm, Cm, cfg.ssm_chunk),
            "flash": lambda: fops.flash_attention(q, k, v, causal=True,
                                                  scale=cfg.attn_scale)}
        for tname, target in targets.items():
            target()
            for bname, first in before.items():
                times = []
                for _ in range(15):
                    first()
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    target()
                    e1.record()
                    torch.cuda.synchronize()
                    times.append(e0.elapsed_time(e1))
                out[f"{tname}_{bname}_ms"] = float(np.median(times))
    del p, zx, Y, X, Adt, Bm, Cm, x, q, k, v
    torch.cuda.empty_cache()
    return out


class Clocks:
    """While active, ``nvidia-smi`` samples the card's SM clock (MHz) and
    power draw (W) every 20 ms; ``summary`` holds their mean, least and
    most over the samples."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(0.5)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        text = self.proc.communicate(timeout=10)[0]
        rows = []
        for line in text.splitlines():
            try:
                rows.append([float(f) for f in line.split(",")])
            except ValueError:
                continue
        self.summary = {"samples": len(rows)}
        for i, name in enumerate(("sm_mhz", "power_w")):
            vals = [r[i] for r in rows if len(r) == 2]
            if vals:
                self.summary[name] = {"mean": float(np.mean(vals)),
                                      "min": min(vals), "max": max(vals)}


def prefill_split(model, cfg, Bsz, S, runs=SPLIT_RUNS, plain=False):
    """18 (b): one ``Bsz`` x ``S`` prefill's device ms by piece, CUDA events
    around the program's pieces on its one stream (the mean of ``runs``
    warm prefills), the mix kernels' launches a prefill and the card's SM
    clock and power through the prefills (:class:`Clocks`).  ``plain``
    sends the mixer's CUDA tensors to its plain version (the route before
    the kernels), for the comparison of 19 (c)."""
    from collections import defaultdict

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import blocks
    from repro_torch.runtime import make_prefill_step
    pending = []

    def timed(name, fn):
        def wrapped(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            pending.append((name, e0, e1))
            return out
        return wrapped

    pieces = ((blocks, "_attend", "shared_attention"),
              (blocks, "_shared_mlp", "shared_mlp"),
              (blocks, "mamba2_mixer", "mamba_mixer"),
              (sops, "ssd", "ssd"), (fops, "flash_attention", "flash"),
              (mops, "mix_in", "mix_in"), (mops, "mix_out", "mix_out"))
    toks = torch.as_tensor(np.random.default_rng(S).integers(
        0, cfg.vocab, (Bsz, S)), dtype=torch.int32, device="cuda")
    step = make_prefill_step(cfg, capacity=S + NEW_TOKENS)
    step(model, {"tokens": toks})
    torch.cuda.synchronize()
    orig = {(mod, name): getattr(mod, name) for mod, name, _ in pieces}
    on_card = mops._on_card
    acc = defaultdict(float)
    launches = []
    clocks = Clocks()
    try:
        if plain:
            mops._on_card = lambda t: False
        for mod, name, label in pieces:
            setattr(mod, name, timed(label, getattr(mod, name)))
        clocks.__enter__()
        for _ in range(runs):
            pending.clear()
            before = dict(mops.LAUNCHES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(model, {"tokens": toks})
            e1.record()
            torch.cuda.synchronize()
            launches.append({k: v - before[k]
                             for k, v in mops.LAUNCHES.items()})
            acc["total"] += e0.elapsed_time(e1) / runs
            for name, a, b in pending:
                acc[name] += a.elapsed_time(b) / runs
            del out
    finally:
        if hasattr(clocks, "proc"):
            clocks.__exit__()
        mops._on_card = on_card
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)
    acc["mamba_mixer_without_ssd"] = acc["mamba_mixer"] - acc["ssd"]
    acc["rest"] = (acc["total"] - acc["mamba_mixer"]
                   - acc["shared_attention"] - acc["shared_mlp"])
    n = 0 if plain else cfg.n_layers
    if any(got != {"mix_in": n, "mix_out": n} for got in launches):
        raise AssertionError(f"{ZYPHRA} {Bsz} x {S}: mix launches a prefill "
                             f"{launches}, want {n} each")
    return {"requests": Bsz, "prompt": S, "launches_per_prefill":
            launches[0], "clocks": clocks.summary,
            **{k: float(v) for k, v in acc.items()}}


def mamba2_mix_phase(err, launches=None):
    """Phase 18 (see the module docstring): the ``mamba2_mix_in`` and
    ``mamba2_mix_out`` records; ``launches`` is the main path's count
    (phase 8's zamba2 serve), or the split's prefills' when None."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    cfg = get_config(ZYPHRA)
    timed = mix_kernels(cfg)
    for name, cases in timed.items():
        for e in cases:
            log(f"phase 18: {name} {e['shape']}: {e['ms']:.4f} ms (plain "
                f"{e['plain_ms']:.4f}, bound {e['bound_ms']:.4f} by "
                f"{e['bound_by']}, {e['bound_ms'] / e['ms']:.1%} of it)")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    splits = []
    with torch.no_grad():
        for S in reversed(MIX_PROMPTS):
            sp = prefill_split(model, cfg, ZYPHRA_B, S)
            splits.append(sp)
            log(f"phase 18: {ZYPHRA} prefill {ZYPHRA_B} x {S} device ms "
                f"(CUDA events, mean of {SPLIT_RUNS}): " + json.dumps(
                    {k: round(v, 3) if isinstance(v, float) else v
                     for k, v in sp.items()}))
        # 19 (c): the same prefill by the plain route, then the neighbours
        plain_split = prefill_split(model, cfg, ZYPHRA_B, MIX_PROMPTS[-1],
                                    plain=True)
    log(f"phase 18: {ZYPHRA} prefill {ZYPHRA_B} x {MIX_PROMPTS[-1]} by the "
        f"plain route, device ms (CUDA events, mean of {SPLIT_RUNS}): "
        + json.dumps({k: round(v, 3) if isinstance(v, float) else v
                      for k, v in plain_split.items()}))
    del model
    torch.cuda.empty_cache()
    near = neighbours(cfg)
    log(f"phase 18: ssd and flash at {ZYPHRA_B} x {MIX_PROMPTS[-1]} by what "
        f"ran just before them (median ms of 15): " + json.dumps(near))
    per_prefill = splits[0]["launches_per_prefill"]
    main = launches or {k: sum(sp["launches_per_prefill"][k]
                               for sp in splits) * SPLIT_RUNS
                        for k in per_prefill}
    out = []
    for name, kernel in (("mamba2_mix_in", "mix_in"),
                         ("mamba2_mix_out", "mix_out")):
        cases = timed[name]
        last = cases[-1]
        out.append(_entry(
            name, {name: main[kernel]}, err, last["ms"], last["plain_ms"],
            None, last["bytes"], 0,
            f"{ZYPHRA} prefill, zxbcdt ({ZYPHRA_B}, {MIX_PROMPTS[-1]}, "
            f"{2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state}"
            f" + {cfg.ssm_heads}) bf16", cases=cases,
            launches_per_prefill=per_prefill[kernel], splits=splits,
            plain_split=plain_split, neighbours=near))
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    return out


def mamba2_mix_bench():
    """Phase 18 alone on the card, with its builds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    log(device_line())
    built = build.build_all([mops.SOURCE, sops.SOURCE, fops.SOURCE,
                             dops.SOURCE])
    path, secs = built["mamba2_mix"]
    log(f"phase 18: built {os.path.relpath(path, ROOT)} in {secs:.2f} s; "
        f"registers and [spill store, spill load] bytes: " + json.dumps(
            kernel_report(mops.SOURCE, path,
                          keep=lambda name: "kernel" in name)))
    err = {}
    print(json.dumps({"kernels": mamba2_mix_phase(err)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # full float32 products: the f32 tolerances hold no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.admission import ops as aops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_mix import ops as mops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.wastage import ops
    from repro_torch.models import init_params
    from repro_torch.sched import evaluate_workflow
    from repro_torch.traces import eager, sarek

    # 1. device line
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x {torch.cuda.device_count()}")

    # 2. build: every source at once, one nvcc each
    t0 = time.perf_counter()
    built = build.build_all([ops.SOURCE, sops.SOURCE, fops.SOURCE,
                             aops.SOURCE, dops.SOURCE, mops.SOURCE])
    build_wall = time.perf_counter() - t0
    path, secs = built["wastage"]
    log(f"phase 2: built {os.path.relpath(path, ROOT)} in {secs:.2f} s; "
        f"wastage_groups<mode> (probe 0, eval 1, engine 2) registers and "
        f"[spill store, spill load] bytes: " + json.dumps(kernel_report(
            ops.SOURCE, path, keep=lambda name: "wastage_groups" in name)))
    path, secs = built["admission"]
    log(f"phase 2: built {os.path.relpath(path, ROOT)} in {secs:.2f} s; "
        f"drain_kernel<masked,headroom> and columns_kernel<masked> "
        f"registers and [spill store, spill load] bytes: " + json.dumps(
            kernel_report(aops.SOURCE, path,
                          keep=lambda name: "_kernel" in name)))

    # 3. the card tests
    secs, summary = card_tests()
    log(f"phase 3: python -m pytest -q -m cuda tests/: {summary} "
        f"({secs:.1f} s)")
    err = {}

    # 4. main path at paper size, card vs the plain path on the CPU
    tables = engine_tables(ops)
    ops.reset_launches()
    with tables, FleetCalls() as calls:
        card = {wf.name: evaluate_workflow(wf, device="cuda", **KW)
                for wf in (eager(), sarek())}
    launches = dict(ops.LAUNCHES)
    check_launches(launches, calls, "phase 4")
    for name, res in card.items():
        log(f"phase 4: {name} on the card, stage seconds {res.seconds}")
        cpu = evaluate_workflow(
            eager() if name == "eager" else sarek(), device="cpu", **KW)
        compare_runs(res, cpu, name)
        ks = {f: m["ks+auto"].chosen_k for f, m in res.fitted.items()}
        log(f"phase 4: {name} card == cpu; chosen k {ks}")
    log(f"phase 4: main-path launches {launches} for {len(calls.calls)} "
        f"fleet calls {calls.split()}")

    # 5. fleet scale on the card
    big, res, rec = fleet_scale(recorders=(tables,))
    check_launches(rec["launches"], rec["fleet_calls"], "phase 5")
    n_test = sum(len(v) for v in big.split(0, 0.5, 1.0)[1].values())
    for m, r in res.methods.items():
        if not (math.isfinite(r.total_gbs) and r.total_gbs > 0):
            raise AssertionError(f"fleet scale {m}: wastage {r.total_gbs}")
    base = min(r.total_gbs for m, r in res.methods.items()
               if not m.startswith("ks+"))
    log(f"phase 5: sarek(2000) {n_test} test executions x "
        f"{len(res.methods)} methods = {n_test * len(res.methods)} lanes; "
        f"wastage reduction vs best baseline: ks+ "
        f"{(base - res.methods['ks+'].total_gbs) / base:.4f}, ks+auto "
        f"{(base - res.methods['ks+auto'].total_gbs) / base:.4f}; "
        + json.dumps(rec))

    # 6. fleet_engine parity at every group table the main path launched
    recorded = sorted(tables.seen, key=lambda c: -c[0].n_lanes)
    lanes = check_engine([(f"main path {describe(t)[1]}", t, mm, dt, n)
                          for t, mm, dt, n in recorded], err)
    log(f"phase 6: fleet_engine == plain engine at all {len(recorded)} group "
        f"tables phases 4 and 5 launched ({lanes} lanes; largest "
        f"{describe(recorded[0][0])}), max abs err {err['fleet_engine']}")

    kernels = wastage_timings(res, big, recorded, launches, err)
    for k in kernels:
        log(f"phase 6: {k['name']} {k['ms']:.4f} ms (plain "
            f"{k['plain_ms']:.4f}, bound {k['bound_ms']:.5f} by "
            f"{k['bound_by']}) over {k['groups']}")
    del tables, recorded

    # 7. the LM kernels, built beside the wastage kernels in phase 2
    log("phase 7: built " + ", ".join(
        f"{os.path.relpath(built[n][0], ROOT)} in {built[n][1]:.2f} s"
        for n in ("ssd", "flash_attention", "decode_attention",
                  "mamba2_mix")) +
        f" (all six sources in parallel: {build_wall:.2f} s wall)")
    for name, src in (("ssd", sops.SOURCE), ("flash_attention", fops.SOURCE)):
        log(f"phase 7: {name} bf16 kernels (registers, [spill store, spill "
            f"load] bytes, HGMMA instructions): " + json.dumps(
                kernel_report(src, built[name][0])))
    log("phase 7: decode_attention kernels (registers, [spill store, spill "
        "load] bytes): " + json.dumps(kernel_report(
            dops.SOURCE, built["decode_attention"][0],
            keep=lambda name: "kernel" in name)))
    log("phase 7: mamba2_mix kernels (registers, [spill store, spill "
        "load] bytes): " + json.dumps(kernel_report(
            mops.SOURCE, built["mamba2_mix"][0],
            keep=lambda name: "kernel" in name)))

    # 8. serving at full width: serve_demo's loop through the port
    cfg = get_config(ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 8: {ARCH} init_params on the card: {n_params} parameters "
        f"in {time.perf_counter() - t0:.2f} s")
    serve(model, cfg, ((1, 256),), 2, seed=99)  # warm-up, not counted
    for o in (ops, sops, fops, dops, mops):
        o.reset_launches()
    rec_ssd, rec_flash = lm_recorders()
    with rec_ssd, rec_flash:
        records = serve(model, cfg, SERVE_BATCHES, NEW_TOKENS, seed=0)
    lm_launches = {"ssd": sops.LAUNCHES["ssd"],
                   "flash_attention": fops.LAUNCHES["flash_attention"],
                   "decode_attention": dops.LAUNCHES["decode_attention"]}
    mix_launches = dict(mops.LAUNCHES)
    want = {"ssd": cfg.n_layers,
            "flash_attention": cfg.n_layers // cfg.shared_attn_every}
    for r in records:
        log(f"phase 8: {r['requests']} x {r['prompt']} tokens: prefill "
            f"{r['prefill_s']:.4f} s, decode {r['new_tokens']} tokens in "
            f"{r['decode_s']:.4f} s = {r['decode_tok_per_s']:.1f} tokens/s,"
            f" peak {r['peak_gb']:.2f} GB; launches per prefill "
            f"{r['prefill_launches']}, in decode {r['decode_launches']}; "
            f"logits finite {r['finite']}")
        if r["prefill_launches"] != want:
            raise AssertionError(f"prefill launched {r['prefill_launches']}"
                                 f", want one per block: {want}")
        if any(r["decode_launches"].values()):
            raise AssertionError("decode launched a prefill kernel")
        check_decode_launches(r, want["flash_attention"], ARCH)
        check_mix_launches(r, cfg.n_layers, ARCH)
        if not r["finite"]:
            raise AssertionError("non-finite logits")
    if min(lm_launches.values()) <= 0:
        raise AssertionError(f"serving launched {lm_launches}")
    log(f"phase 8: main-path launches {lm_launches}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    records[0]["prefill_warm"] = warm_prefill(model, cfg, *SERVE_BATCHES[0])
    log("phase 8: records " + json.dumps(records))
    log("phase 8: profile " + json.dumps(
        profile_call(prefill_call(model, cfg, *SERVE_BATCHES[0]))[1]))
    del model
    torch.cuda.empty_cache()

    # 9. card vs CPU at full width, reduced depth
    for dtype_name in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        worst = card_vs_cpu(dtype_name)
        diff = max(d for d, _, _ in worst.values())
        rel = max(r for _, _, r in worst.values())
        log(f"phase 9: {ARCH} 6 Mamba2 blocks + shared block, {dtype_name}"
            f": card == cpu on prefill(300) + 4 decode steps (logits and "
            f"caches), max abs diff {diff:.3g}, max relative L2 {rel:.3g} "
            f"({time.perf_counter() - t0:.1f} s); per tensor (max abs "
            f"diff, max abs value, relative L2) "
            + json.dumps({k: [float(f"{x:.3g}") for x in v]
                          for k, v in worst.items()}))

    # 10. LM kernel parity at every shape phase 8 launched, then timings
    flash, ssd = phase_shape_cases(rec_ssd.seen, rec_flash.seen)
    check_lm_kernels(flash, ssd, err)
    log(f"phase 10: kernel == plain at the {len(ssd)} ssd and {len(flash)} "
        f"flash_attention shapes serving launched "
        f"{sorted(rec_ssd.seen, key=str)} {sorted(rec_flash.seen, key=str)}"
        f", max abs err ssd {err['ssd']:.3g} flash_attention "
        f"{err['flash_attention']:.3g}")
    del flash, ssd
    kernels += lm_kernel_timings(lm_launches, err)
    for k in kernels[3:]:
        log(f"phase 10: {k['name']} {k['ms']:.4f} ms (plain "
            f"{k['plain_ms']:.4f}, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.4f} by {k['bound_by']})")

    # 11. the cluster replay at the reference benchmark's full size
    rec, seen, adm = cluster_phase(err)
    r = rec["replay"]
    # the kernel line's oom_probe: the cluster path, where it launches now;
    # phase 6's split timing stays beside it
    fleet_probe = kernels[0]
    kernels[0] = cluster_probe_entry(
        seen, {"oom_probe": r["launches"]["oom_probe"]}, err)
    kernels[0]["fleet_launches"] = fleet_probe["launches"]
    kernels[0]["sarek_split"] = {k: fleet_probe[k] for k in (
        "ms", "plain_ms", "bound_ms", "bytes", "groups")}
    k = kernels[0]
    log(f"phase 11: oom_probe at the replay's table {k['ms']:.4f} ms (plain "
        f"{k['plain_ms']:.4f}, bound {k['bound_ms']:.5f} by "
        f"{k['bound_by']}) over {k['groups']}")
    kernels += adm

    # 12. the prediction service on the card
    t0 = time.perf_counter()
    rec, serve_tables = prediction_service(err)
    sat = rec["saturation"]
    thr, lat, disc = sat["throughput"], sat["latency"], sat["discipline"]
    log(f"phase 12: run_saturation: {thr['req_s_batched']:.1f} req/s "
        f"batched, {thr['req_s_unbatched']:.1f} unbatched (x"
        f"{thr['speedup_x']:.2f}), mean batch {thr['mean_batch']:.1f}; "
        f"p50 {lat['p50_ms']:.4f} ms, p99 {lat['p99_ms']:.4f} ms at "
        f"{lat['rate_rps']:g} req/s; cache hit rate "
        f"{disc['cache_hit_rate']}; bitwise, no warm build or load; "
        f"fleet_engine launches {sat['launches']['fleet_engine']} "
        f"({sat['seconds']:.2f} s)")
    h = rec["histories"]
    for side in ("card", "cpu"):
        r = h[side]
        log(f"phase 12: sarek({h['instances']}) histories on the {side}: "
            f"{r['tenants']} tenants x {r['families']} families seeded in "
            f"{r['seed_s']:.3f} s; per evaluate cold "
            f"{r['cold']['evaluate']['mean_s']:.5f} s, warm "
            f"{r['warm']['evaluate']['mean_s']:.5f} s; per tune cold "
            f"{r['cold']['tune']['mean_s']:.5f} s, warm "
            f"{r['warm']['tune']['mean_s']:.5f} s")
    log(f"phase 12: card == cpu on every family's evaluate and tune_offset;"
        f" fleet_engine launches {h['launches']['fleet_engine']}, one per "
        f"evaluate dispatch and per tune group; serve.dev_sync once per "
        f"(tenant, family, snapshot) cold, never warm")
    tr = rec["traced"]
    log(f"phase 12: {tr['tasks']}-task fused replay traced == untraced "
        f"({tr['traced_s']:.3f} s vs {tr['untraced_s']:.3f} s): "
        f"{tr['drains']} drains = {tr['dispatches']['admission.drain']} "
        f"admission.drain dispatches, {tr['host_reads']} host reads for "
        f"{tr['drain_iterations']} drain iterations; {tr['events']} events "
        f"in {tr['trace']}; top spans:")
    for line in tr.pop("summary").splitlines()[:8]:
        log("phase 12:   " + line)
    d = rec["serve_demo"]
    log(f"phase 12: serve_demo(qwen3-1.7b) on the card: served "
        f"{d['served']} in {d['batches']} batches ({d['wall_s']:.2f} s), as "
        f"on the cpu")
    engine = next(k for k in kernels if k["name"] == "fleet_engine")
    sv = serve_engine_entry(engine, serve_tables,
                            h["launches"]["fleet_engine"], err)
    log(f"phase 12: fleet_engine == plain engine at all "
        f"{sv['tables_checked']} serve tables ({sv['lanes_checked']} "
        f"lanes); at the largest {sv['ms']:.4f} ms (plain "
        f"{sv['plain_ms']:.4f}, bound {sv['bound_ms']:.5f} by "
        f"{sv['bound_by']}) over {sv['groups']} "
        f"({time.perf_counter() - t0:.1f} s) " + json.dumps(rec))

    # 13. training on the card
    t0 = time.perf_counter()
    train = training(kernels, err, built)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # 14. the moe, vlm and audio families
    fam = families(kernels, err)

    # 15. the dry run and the roofline against the steps the card ran
    dry_run_phase({"serve": records, "train": train, **fam})

    # 16. decode attention: parity, then timed at the olmoe cells' shapes
    kernels += decode_attention_phase(
        err, fam["olmoe"]["launches"]["decode_attention"])

    # 17. Zamba2-2.7B in Zyphra's form: launches, hd-160 kernels
    zyphra_phase(kernels, err)

    # 18. the Mamba2 mix kernels: parity, timings, a prefill's split
    kernels += mamba2_mix_phase(err, mix_launches)
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
