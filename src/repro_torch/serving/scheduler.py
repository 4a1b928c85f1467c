"""Batched request scheduler for the serving examples, as in
`repro.serving.scheduler`.

Continuous-batching-lite: requests queue up, the scheduler packs up to
`max_batch` compatible requests (same HMM / model), pads sequences to the
bucket boundary, runs one batched decode, and fans results back out.  Buckets
bound the number of distinct batch shapes.

The decode function receives the true lengths alongside the padded batch:
``decode_batch_fn(padded (B, Tb, K), lengths (B,) int32) -> (paths, scores)``.
Length-aware decoders (``core.viterbi_decode_batch``) mask pad frames as
tropical-identity steps, so every request's path and score are bit-identical
to an unbatched decode of its unpadded payload — padding is a pure throughput
trick, never an approximation.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from ..core.decoder import ViterbiDecoder


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class Request:
    rid: int
    payload: Any                    # (T, K) emissions or token prompt
    arrival: float = 0.0
    result: Any = None
    done: bool = False


class BatchScheduler:
    """Packs requests into padded buckets and runs one batched decode.

    `decode_batch_fn` is either the raw callable contract above, or a
    `core.ViterbiDecoder`; the scheduler then drives its `decode_batch`
    (the decoder owns the device and the lengths contract).  Results may
    come back as tensors on any device: they are copied to numpy once per
    batch.
    """

    def __init__(self, decode_batch_fn, max_batch: int = 8,
                 buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048)):
        if isinstance(decode_batch_fn, ViterbiDecoder):
            decode_batch_fn = decode_batch_fn.decode_batch
        self.fn: Callable = decode_batch_fn
        self.max_batch = max_batch
        self.buckets = sorted(buckets)
        self.queue: deque[Request] = deque()
        self._next_id = itertools.count()
        self.stats = {"batches": 0, "requests": 0, "padded_frac": []}

    def submit(self, payload) -> Request:
        req = Request(rid=next(self._next_id), payload=payload,
                      arrival=time.monotonic())
        self.queue.append(req)
        return req

    def _bucket(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def step(self) -> list[Request]:
        """Run one batch; returns completed requests."""
        if not self.queue:
            return []
        first = self.queue[0]
        bucket = self._bucket(len(first.payload))
        batch: list[Request] = []
        rest: deque[Request] = deque()
        while self.queue and len(batch) < self.max_batch:
            r = self.queue.popleft()
            if self._bucket(len(r.payload)) == bucket:
                batch.append(r)
            else:
                rest.append(r)
        self.queue.extendleft(reversed(rest))

        lens = np.asarray([len(r.payload) for r in batch], np.int32)
        K = batch[0].payload.shape[-1]
        padded = np.zeros((len(batch), bucket, K), np.float32)
        for i, r in enumerate(batch):
            padded[i, :lens[i]] = r.payload  # pad tail masked by the decoder
        paths, scores = self.fn(padded, lens)
        paths, scores = _numpy(paths), _numpy(scores)
        for i, r in enumerate(batch):
            r.result = (paths[i][:lens[i]], float(scores[i]))
            r.done = True
        self.stats["batches"] += 1
        self.stats["requests"] += len(batch)
        self.stats["padded_frac"].append(1 - np.mean(lens) / bucket)
        return batch

    def drain(self) -> list[Request]:
        done = []
        while self.queue:
            done.extend(self.step())
        return done


__all__ = ["Request", "BatchScheduler"]
