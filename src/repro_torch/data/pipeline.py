"""Deterministic synthetic data pipeline (numpy; the port's own copy of the
reference's ``data/pipeline.py``, batches bitwise the same).

Batches are a pure function of ``(seed, step, shard)`` so every host in a
multi-host deployment generates exactly its own shard with no coordination,
and a restarted / resharded job (elastic scaling, failure recovery) resumes
bit-identically from the step counter alone — the data-side half of the
fault-tolerance story.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["SyntheticLMDataset", "host_batch"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: Optional[int] = None   # set for stubbed-frontend families
    mrope: bool = False

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict:
        """One data-parallel shard of the global batch for ``step``."""
        assert self.global_batch % num_shards == 0
        b = self.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        out: Dict[str, np.ndarray] = {}
        # Markov token stream: with p=0.8 the next token is (prev + 7) mod V,
        # so even tiny smoke models visibly learn within tens of steps while
        # ~100M models keep improving for a few hundred.
        toks = rng.integers(0, self.vocab, (b, self.seq_len + 1), dtype=np.int32)
        mask = rng.random((b, self.seq_len)) < 0.8
        nxt = (toks[:, :-1] + 7) % self.vocab
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        if self.embed_dim is not None:
            out["embeds"] = rng.standard_normal(
                (b, self.seq_len, self.embed_dim)).astype(np.float32)
            out["labels"] = toks[:, 1:]
        else:
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:]
        if self.mrope:
            pos = np.arange(self.seq_len, dtype=np.int32)
            out["positions"] = np.broadcast_to(
                pos[None, :, None], (b, self.seq_len, 3)).copy()
        return out


def host_batch(cfg, seq_len: int, global_batch: int, step: int,
               seed: int = 0, shard: int = 0, num_shards: int = 1) -> Dict:
    ds = SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed,
        embed_dim=cfg.d_model if cfg.family in ("vlm", "audio") else None,
        mrope=cfg.mrope_sections is not None)
    return ds.batch(step, shard, num_shards)
