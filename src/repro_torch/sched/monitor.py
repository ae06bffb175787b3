"""Online memory monitoring: feeds live ML-job memory traces into KS+.

``MemoryMonitor`` samples the current process RSS (host-side job memory —
the quantity the paper's resource managers limit) during training/serving
steps; accumulated traces per job type become KS+ training data, closing
the loop: observe → segment → predict → allocate the next job.

``HBMFootprintModel`` provides the device-side analogue from dry-run
artifacts: predicted device-memory envelope of a step as a function of the
token count (the ML-world 'input size'), so the elastic scheduler can
bin-pack jobs onto device slices before building anything.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List

import numpy as np

from repro_torch.core import KSPlus

__all__ = ["read_rss_gb", "MemoryMonitor", "HBMFootprintModel"]

_PAGE = os.sysconf("SC_PAGE_SIZE")


def read_rss_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * _PAGE / 2**30


@dataclasses.dataclass
class MemoryMonitor:
    """Collects (elapsed_s, rss_gb) samples for one logical job."""

    job_type: str
    input_size: float       # job 'input size' (e.g. tokens, GB of data)
    dt: float = 0.5
    _t0: float = dataclasses.field(default_factory=time.monotonic)
    _last: float = dataclasses.field(default=-1e9)
    samples: List[float] = dataclasses.field(default_factory=list)

    def sample(self, force: bool = False):
        now = time.monotonic()
        if force or now - self._last >= self.dt:
            self.samples.append(read_rss_gb())
            self._last = now

    def trace(self) -> np.ndarray:
        return np.asarray(self.samples if self.samples else [read_rss_gb()])


class HBMFootprintModel:
    """KS+ applied to device-memory envelopes of compiled jobs.

    Fit on (tokens, per-step HBM envelope) observations — e.g. from dry-run
    ``memory_analysis`` at several batch sizes — then predict the envelope
    for a new job size.  Architecture-agnostic (§Arch-applicability).
    The KS+ fit runs on ``device`` (None means the card).
    """

    def __init__(self, k: int = 3, device=None):
        self.model = KSPlus(k=k, device=device)
        self._obs: List = []

    def observe(self, tokens: float, envelope_gb: np.ndarray, dt: float = 1.0):
        self._obs.append((tokens, np.asarray(envelope_gb, float), dt))

    def fit(self):
        mems = [o[1] for o in self._obs]
        dts = [o[2] for o in self._obs]
        inputs = [o[0] for o in self._obs]
        self.model.fit(mems, dts, inputs)
        return self

    def predict(self, tokens: float):
        return self.model.predict(tokens)
