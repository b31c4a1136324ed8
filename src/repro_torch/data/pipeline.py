"""Deterministic synthetic token pipeline (a copy of ``repro.data.pipeline``
without its unused ``import jax``; the rest is numpy).

Design requirements at 1000-node scale:

* **Stateless addressing** — ``batch_at(step)`` is a pure function of
  ``(seed, step)``, so a restarted or elastically re-meshed job resumes the
  exact data order from the checkpointed step with no iterator state to
  save (the checkpoint stores only the integer step).
* **Shard-local generation** — each host materializes only its slice of the
  global batch (``host_slice``); nothing global is ever allocated, so the
  pipeline scales to any global batch size.
* **Learnable distribution** — tokens follow a Zipfian unigram mixed with a
  deterministic bigram successor rule, so the LM loss has signal to descend
  (integration tests assert loss decreases on this stream).
* **Prefetch** — a small background thread keeps ``prefetch`` batches ahead
  of the training loop, overlapping host-side generation with device steps.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2
    bigram_fraction: float = 0.5     # fraction of positions forced by bigram


class SyntheticLM:
    """Zipf + bigram synthetic language."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self.probs = probs / probs.sum()
        # deterministic successor table: bigram rule t -> (a*t + c) % vocab
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        self.succ_mul = int(rng.integers(3, 97)) * 2 + 1       # odd => bijective
        self.succ_add = int(rng.integers(0, cfg.vocab))

    def successor(self, tok: np.ndarray) -> np.ndarray:
        return (tok * self.succ_mul + self.succ_add) % self.cfg.vocab

    def batch_at(self, step: int, *, host_slice: slice | None = None
                 ) -> Dict[str, np.ndarray]:
        """Batch for ``step`` (pure function).  Returns {tokens, labels}.

        ``host_slice`` selects the rows this host owns; default is the full
        global batch (single-host testing).
        """
        cfg = self.cfg
        sl = host_slice or slice(0, cfg.global_batch)
        rows = range(sl.start, min(sl.stop, cfg.global_batch))
        n = len(rows)
        out = np.empty((n, cfg.seq_len + 1), dtype=np.int64)
        for i, r in enumerate(rows):
            rng = np.random.default_rng((cfg.seed, step, r))
            seq = rng.choice(cfg.vocab, size=cfg.seq_len + 1, p=self.probs)
            use_bigram = rng.random(cfg.seq_len) < cfg.bigram_fraction
            # sequential chain: bigram positions continue from the *final*
            # previous token, so labels really are predictable at the
            # configured rate (tests/test_substrate.py checks the rate).
            # vectorized per run: within a bigram run of length k starting
            # after a free token t0, token j is successor^j(t0); iterate
            # runs via simple loop over breakpoints (few per row).
            free = np.flatnonzero(~use_bigram)
            pos = 0
            for end in list(free) + [cfg.seq_len]:
                # positions pos..end-1 are bigram-forced
                for t in range(pos, end):
                    seq[t + 1] = (seq[t] * self.succ_mul + self.succ_add) \
                        % cfg.vocab
                pos = end + 1
            out[i] = seq
        out = out.astype(np.int32)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}


class PrefetchIterator:
    """Background-thread prefetch over ``batch_at`` starting at ``step0``."""

    def __init__(self, ds: SyntheticLM, step0: int = 0, prefetch: int = 2,
                 host_slice: slice | None = None):
        self.ds = ds
        self.step = step0
        self.host_slice = host_slice
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            b = self.ds.batch_at(s, host_slice=self.host_slice)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=2)


def make_pipeline(vocab: int, seq_len: int, global_batch: int, *,
                  seed: int = 0, step0: int = 0,
                  host_index: int = 0, host_count: int = 1,
                  prefetch: int = 2) -> PrefetchIterator:
    """Standard entry point: shard rows across hosts, prefetch in background."""
    cfg = DataConfig(vocab=vocab, seq_len=seq_len, global_batch=global_batch,
                     seed=seed)
    per_host = global_batch // host_count
    sl = slice(host_index * per_host, (host_index + 1) * per_host)
    return PrefetchIterator(SyntheticLM(cfg), step0=step0, prefetch=prefetch,
                            host_slice=sl)
