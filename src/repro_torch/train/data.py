"""Data pipeline: synthetic-but-learnable corpora + shard-aware batching
(numpy only; batches are byte-identical to the reference's for the same
arguments).

Offline image => no real GLUE; benchmarks that need learnable signal
(the Fig. 8 estimator-comparison run, the end-to-end examples) use a
Markov-chain language whose transition structure a model can actually
fit, so loss curves are meaningful.  Sample identity (``sample_ids``) is
tracked so the dataset-level gradient-norm cache (Algorithm 1) works
exactly as in the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Order-1 Markov corpus with a planted low-entropy structure."""
    vocab_size: int
    seq_len: int
    n_samples: int
    seed: int = 0
    branching: int = 4      # out-degree per state: lower => more learnable

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = self.vocab_size
        self._succ = rng.randint(0, v, size=(v, self.branching))
        self._tokens = np.empty((self.n_samples, self.seq_len + 1),
                                np.int32)
        state = rng.randint(0, v, size=self.n_samples)
        self._tokens[:, 0] = state
        for t in range(1, self.seq_len + 1):
            choice = rng.randint(0, self.branching, size=self.n_samples)
            state = self._succ[state, choice]
            self._tokens[:, t] = state

    def batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        toks = self._tokens[ids]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def steps_per_epoch(self, batch_size: int, n_hosts: int = 1) -> int:
        return (self.n_samples // n_hosts) // batch_size

    def batch_at(self, step: int, batch_size: int, *, host_id: int = 0,
                 n_hosts: int = 1) -> Dict[str, np.ndarray]:
        """The batch a sequential trainer sees at global ``step`` —
        stateless and deterministic, so a killed-and-resumed run replays
        exactly the batches the uninterrupted run would have seen
        (epoch ``step // steps_per_epoch`` is shuffled with its epoch
        index as the seed; within an epoch, consecutive slices)."""
        per = self.steps_per_epoch(batch_size, n_hosts)
        if per < 1:
            raise ValueError(
                f"batch_size {batch_size} x {n_hosts} hosts exceeds "
                f"n_samples {self.n_samples}")
        epoch, pos = divmod(int(step), per)
        cache_key = (epoch, host_id, n_hosts)
        if getattr(self, "_order_cache_key", None) != cache_key:
            order = np.random.RandomState(epoch).permutation(
                self.n_samples)[host_id::n_hosts]
            self._order_cache_key, self._order_cache = cache_key, order
        ids = self._order_cache[pos * batch_size:(pos + 1) * batch_size]
        b = self.batch(ids)
        b["sample_ids"] = ids.astype(np.int32)
        return b

    def epoch(self, batch_size: int, *, shuffle_seed: int = 0,
              host_id: int = 0, n_hosts: int = 1
              ) -> Iterator[Dict[str, np.ndarray]]:
        """Shard-aware iterator: each host sees a disjoint slice, so the
        global batch is the concatenation across hosts (elastic: pass a
        different n_hosts on resume and the split re-balances)."""
        rng = np.random.RandomState(shuffle_seed)
        order = rng.permutation(self.n_samples)
        order = order[host_id::n_hosts]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            ids = order[i:i + batch_size]
            b = self.batch(ids)
            b["sample_ids"] = ids.astype(np.int32)
            yield b


def copy_task(vocab_size: int, seq_len: int, n_samples: int, seed: int = 0
              ) -> Dict[str, np.ndarray]:
    """Second half copies the first half; strong signal for quick tests."""
    rng = np.random.RandomState(seed)
    half = seq_len // 2
    first = rng.randint(2, vocab_size, size=(n_samples, half))
    toks = np.concatenate([first, first], axis=1).astype(np.int32)
    labels = np.concatenate(
        [np.full((n_samples, half - 1), -100), toks[:, half - 1:]],
        axis=1).astype(np.int32)
    return {"tokens": toks[:, :seq_len],
            "labels": labels[:, :seq_len]}
