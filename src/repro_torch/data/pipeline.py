"""Deterministic sharded synthetic-corpus pipeline with checkpointable state.

Tokens are a counter-based PRF of (seed, step, shard): any (host, step) can
regenerate its shard without coordination or file I/O, restart is exact
(state = one integer), and every host draws disjoint data.  The synthetic
"corpus" is Zipf-distributed token ids with document boundaries — enough
structure for a language-model loss to fall during the example runs.

A real deployment swaps `_tokens_for` for tokenized shards on disk; the
loop/checkpoint interface (next_batch / state / restore) is unchanged.

A numpy copy of the reference's ``data/pipeline.py``: its batches are the
reference's bit for bit, for every seed, shard and restore point.
:class:`FramesPipeline` is the port's own: it adds the stub encoder frames
that an encoder-decoder's loss reads (the reference's loop feeds tokens
only, so it cannot train whisper: ROADMAP Queue C R7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

BOS = 1


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        return cls(step=int(d.get("step", 0)))


class DataPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1,
                 mean_doc_len: int = 256):
        assert global_batch % num_shards == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.mean_doc_len = mean_doc_len
        self.state = PipelineState()
        # Zipf-ish unigram distribution over the vocab (precomputed CDF)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        probs[:4] = probs.max() * 2          # specials stay frequent
        self._cdf = np.cumsum(probs / probs.sum())

    def _rng_for(self, step: int, row: int) -> np.random.Generator:
        mask = (1 << 64) - 1
        key = ((self.seed * 0x9E3779B97F4A7C15) & mask) \
            ^ ((step * 0xBF58476D1CE4E5B9) & mask) \
            ^ (self.shard * 65536 + row)
        return np.random.default_rng(key & mask)

    def _tokens_for(self, step: int, row: int) -> np.ndarray:
        rng = self._rng_for(step, row)
        u = rng.random(self.seq_len)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        # document boundaries: BOS roughly every mean_doc_len tokens
        n_docs = max(self.seq_len // self.mean_doc_len, 1)
        starts = rng.integers(0, self.seq_len, n_docs)
        toks[starts] = BOS
        toks[0] = BOS
        return np.clip(toks, 0, self.vocab_size - 1)

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.step
        batch = np.stack([self._tokens_for(step, r)
                          for r in range(self.local_batch)])
        self.state = PipelineState(step=step + 1)
        return {"tokens": batch}

    # ---- checkpoint integration ---- #
    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def restore(self, d: Optional[Dict]) -> None:
        if d:
            self.state = PipelineState.from_dict(d)


FRAMES_STREAM = 0xF4A3E5     # keeps the frames' draws apart from the tokens'


class FramesPipeline:
    """A :class:`DataPipeline` whose batches also hold ``frames [B, T, D]``,
    standard-normal float32 stand-ins for an audio front end's output, drawn
    from (seed, step, shard) like the tokens, so a restore replays them
    exactly.  State, checkpointing and tokens are the wrapped pipeline's."""

    def __init__(self, base: DataPipeline, frames: int, d_model: int):
        self.base = base
        self.frames = frames
        self.d_model = d_model

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.base
        rng = np.random.default_rng([b.seed, b.state.step, b.shard,
                                     FRAMES_STREAM])
        batch = b.next_batch()
        batch["frames"] = rng.standard_normal(
            (b.local_batch, self.frames, self.d_model), dtype=np.float32)
        return batch

    def state_dict(self) -> Dict:
        return self.base.state_dict()

    def restore(self, d: Optional[Dict]) -> None:
        self.base.restore(d)
