"""Batched, bucketed serving: the front door over ``InferenceEngine`` (the
port of ``styletts2_tpu/serve.py``).

Requests are grouped into token-length buckets, which bounds the padding a
batch carries, and each bucket runs through the engine in chunks of at most
``max_batch``: buckets in ascending order, each bucket's requests in input
order.  The waves come back in input order.

The noise follows the port's rule: ``noise`` (N, 1, 2*style_dim) holds each
request's initial diffusion noise, ``step_noise`` (steps-1, N, 1,
2*style_dim) its ADPM2 step noise and ``source_noise`` (N, 9, >= 600 x the
frame capacity of its chunk) its harmonic source's dither; a chunk takes its
requests' rows.  Diffusion noise not given is drawn from ``generator``; the
dither not given is none, as in the engine.  The JAX front door's
``fold_in(key, bucket * 7919 + start)`` streams have no torch counterpart,
and its data-parallel ``mesh`` is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .infer import InferenceEngine


class BatchSynthesizer:
    """Bucket-and-batch front door over an ``InferenceEngine``."""

    def __init__(self, engine: InferenceEngine, max_batch: int = 64,
                 length_buckets: Sequence[int] = (32, 64, 96, 128, 192, 256)):
        self.engine = engine
        self.max_batch = max_batch
        self.length_buckets = sorted(length_buckets)

    def _bucket_of(self, n: int) -> int:
        """The smallest bucket that holds ``n`` tokens; the last one past it."""
        for b in self.length_buckets:
            if n <= b:
                return b
        return self.length_buckets[-1]

    def chunks(self, phonemes: Sequence[str]) -> List[List[int]]:
        """The request indices of each engine call, in the order they run."""
        order: Dict[int, List[int]] = {}
        for i, p in enumerate(phonemes):
            n = len(self.engine.tokens_from_phonemes(p))
            order.setdefault(self._bucket_of(n), []).append(i)
        return [idxs[start: start + self.max_batch]
                for _, idxs in sorted(order.items())
                for start in range(0, len(idxs), self.max_batch)]

    def synthesize_many(self, phonemes: Sequence[str],
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        diffusion_steps: int = 5,
                        step_noise: Optional[torch.Tensor] = None,
                        source_noise: Optional[torch.Tensor] = None,
                        **kw) -> List[np.ndarray]:
        """Synthesize any number of utterances; returns their waves in input
        order.  ``kw`` goes to ``engine.synthesize`` (``trim_tail``,
        ``ref_s``, ``embedding_scale``, ...)."""
        if generator is None and (noise is None or step_noise is None):
            generator = torch.Generator(self.engine.device).manual_seed(0)

        def rows_of(a, chunk, dim=0):              # the chunk's requests' rows
            if a is None:
                return None
            a = torch.as_tensor(a)
            return a.index_select(dim, torch.tensor(chunk, device=a.device))

        results: List[Optional[np.ndarray]] = [None] * len(phonemes)
        for chunk in self.chunks(phonemes):
            waves = self.engine.synthesize(
                [phonemes[i] for i in chunk], noise=rows_of(noise, chunk),
                step_noise=rows_of(step_noise, chunk, 1),
                source_noise=rows_of(source_noise, chunk),
                generator=generator, diffusion_steps=diffusion_steps, **kw)
            for i, w in zip(chunk, waves):
                results[i] = w
        return results  # type: ignore[return-value]
