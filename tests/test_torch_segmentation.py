"""Algorithm 1: the port's batched segmentation against the reference.

Seeded float32 traces (plateau-heavy ones stress the merge tie-break) go
through ``repro.core.segmentation.get_segments`` lane by lane and through
``repro_torch.core.segmentation.get_segments`` as one batch: S, P and n
must be exact (tolerance: none), as must the per-execution rows that feed
the regressions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.predictor import segment_rows as rows_ref
from repro.core.segmentation import get_segments as seg_ref
from repro_torch.core.predictor import segment_rows as rows_pt
from repro_torch.core.segmentation import (
    get_segments,
    get_segments_ref,
    segments_to_starts,
)
from repro_torch.traces import sarek


def _traces(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(1, 200))
        M = rng.uniform(0.0078125, 100.0, L).astype(np.float32)
        if rng.random() < 0.3:  # plateaus: equal merge errors, ties
            M = (np.round(M / 20.0) * 20.0 + 0.01).astype(np.float32)
        out.append(M)
    return out


def _pad(traces, T):
    pad = np.zeros((len(traces), T), np.float32)
    for i, m in enumerate(traces):
        pad[i, : len(m)] = m
    return pad, np.asarray([len(m) for m in traces], np.int32)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_batched_matches_reference(k):
    traces = _traces(k, 24)
    pad, lengths = _pad(traces, 256)
    S, P, n = get_segments(torch.from_numpy(pad), torch.from_numpy(lengths), k)
    for i, m in enumerate(traces):
        Sr, Pr, nr = seg_ref(jnp.asarray(pad[i]), jnp.int32(lengths[i]), k)
        np.testing.assert_array_equal(S[i].numpy(), np.asarray(Sr))
        np.testing.assert_array_equal(P[i].numpy(), np.asarray(Pr))
        assert int(n[i]) == int(nr)
        # and the numpy oracle (variable length)
        So, Po = get_segments_ref(m, k)
        np.testing.assert_array_equal(S[i].numpy()[: int(n[i])], So)


def test_segment_rows_match_reference():
    wf = sarek(6)
    train, _ = wf.split(0, 0.5, 1.0)
    mems = [e.mem for f in train for e in train[f]]
    dts = [e.dt for f in train for e in train[f]]
    for k in (2, 6):
        for a, b in zip(rows_ref(mems, dts, k),
                        rows_pt(mems, dts, k, device="cpu")):
            np.testing.assert_array_equal(a, b)


def test_segments_to_starts_pads_with_total():
    S = torch.tensor([[3, 2, 0], [4, 0, 0]])
    starts = segments_to_starts(S, torch.tensor([2, 1]))
    np.testing.assert_array_equal(starts.numpy(), [[0, 3, 5], [0, 4, 4]])
