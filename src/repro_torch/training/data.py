"""Synthetic data pipeline (port of `repro.training.data`).

`GrammarDataPipeline` packs grammar-sampled valid strings (EOS-separated)
into fixed-length training batches: the LM learns the formal language
whose grammar later constrains decoding. `RandomTokenPipeline` supplies
shape-correct random batches. Both return numpy batches, the same as the
reference's for the same seed, bit for bit.

Aliasing contract: every `__next__` returns FRESHLY ALLOCATED arrays
(never a reused staging buffer). The training loop ships batches with
`torch.from_numpy(...).to(device, non_blocking=True)`: `from_numpy`
shares the array's memory, and the non-blocking copy can return before
the card has read it, so a reused buffer would be rewritten under an
in-flight copy (the hazard of the serving loop's `.copy()` dispatch
sites; tests/test_torch_training.py holds the pipelines to it).
"""
from __future__ import annotations

import numpy as np

from ..core.sampling import GrammarSampler
from ..core.tokenizer import ByteTokenizer


class GrammarDataPipeline:
    def __init__(self, grammar, tokenizer: ByteTokenizer, seq_len: int,
                 batch_size: int, seed: int = 0, budget: int = 18,
                 max_bytes: int = 400):
        self.sampler = GrammarSampler(grammar, seed=seed)
        self.tok = tokenizer
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.budget = budget
        self.max_bytes = max_bytes
        self._buf: list[int] = []

    def _fill(self, need: int):
        while len(self._buf) < need:
            s = self.sampler.sample(self.budget, max_bytes=self.max_bytes)
            self._buf.extend(self.tok.encode(s, add_eos=True))

    def __iter__(self):
        return self

    def __next__(self):
        S, B = self.seq_len, self.batch_size
        need = B * (S + 1)
        self._fill(need)
        flat = np.asarray(self._buf[:need], dtype=np.int32)
        self._buf = self._buf[need:]
        chunk = flat.reshape(B, S + 1)
        return {
            "tokens": chunk[:, :-1],
            "labels": chunk[:, 1:],
            "loss_mask": np.ones((B, S), np.float32),
        }


class RandomTokenPipeline:
    """The `vlm` and `audio` side inputs are drawn as the reference draws
    them, in fp32: the audio trainer reads `frames` and the vlm trainer
    `image_embeds` (`Model._ctx_from_batch`)."""

    def __init__(self, cfg, seq_len: int, batch_size: int, seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        cfg, S, B = self.cfg, self.seq_len, self.batch_size
        batch = {
            "tokens": self.rng.integers(0, cfg.vocab_size, (B, S),
                                        dtype=np.int32),
            "labels": self.rng.integers(0, cfg.vocab_size, (B, S),
                                        dtype=np.int32),
            "loss_mask": np.ones((B, S), np.float32),
        }
        if cfg.arch_type == "vlm":
            batch["image_embeds"] = self.rng.normal(
                size=(B, cfg.num_image_tokens, cfg.d_model)).astype("float32")
        if cfg.arch_type == "audio":
            batch["frames"] = self.rng.normal(
                size=(B, cfg.audio_frames, cfg.d_model)).astype("float32")
        return batch
