"""Deterministic synthetic data pipeline for the LM substrate (a numpy
copy of ``repro.data.tokens``: the same batches, bit for bit).

``TokenPipeline`` produces a reproducible stream of (tokens, labels) batches
sharded by host: batch ``i`` for host ``h`` of ``H`` is a pure function of
(seed, i, h) — restart-safe (the driver checkpoint records the batch index,
resume regenerates the identical stream) and elastic-safe (re-sharding over a
different host count re-partitions the same global stream).

The "corpus" is a mixture of Zipfian unigrams and short copy motifs so a ~100M
model visibly learns (loss drops well below ln V) within a few hundred steps
— see ``examples/train_lm.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    n_motifs: int = 64

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.local_batch = self.global_batch // self.n_hosts
        rng = np.random.default_rng(self.seed ^ 0xC0FFEE)
        self._motifs = rng.integers(2, self.vocab, (self.n_motifs, self.motif_len))

    def batch(self, index: int) -> dict[str, np.ndarray]:
        """Deterministic batch `index` for this host."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + index) * 4099 + self.host_id)
        b, s = self.local_batch, self.seq_len
        toks = (rng.zipf(self.zipf_a, (b, s + 1)) + 1) % self.vocab
        # splice in copy motifs (learnable structure)
        n_splice = max(1, (s // self.motif_len) // 2)
        for i in range(b):
            for _ in range(n_splice):
                m = self._motifs[rng.integers(0, self.n_motifs)]
                at = rng.integers(0, s + 1 - self.motif_len)
                toks[i, at: at + self.motif_len] = m
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def masked_frame_batch(rng: np.random.Generator, batch: int, seq: int,
                       d_model: int, vocab: int, mask_prob: float = 0.08,
                       mask_span: int = 10) -> dict:
    """HuBERT-style masked-frame batch (frontend stub: random frame embeds)."""
    frames = rng.normal(size=(batch, seq, d_model)).astype(np.float32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.zeros((batch, seq), bool)
    n_starts = max(1, int(seq * mask_prob / mask_span))
    for i in range(batch):
        for st in rng.integers(0, max(seq - mask_span, 1), n_starts):
            mask[i, st: st + mask_span] = True
    return {"frames": frames, "labels": labels, "mask": mask}


def vlm_batch(rng: np.random.Generator, batch: int, seq: int, d_model: int,
              vocab: int, img_frac: float = 0.25) -> dict:
    """Qwen2-VL-style batch (frontend stub): fused embeddings + M-RoPE ids.

    The first ``img_frac`` of the sequence stands in for image patches laid
    out on a (t, h, w) grid; the rest is text with all three streams equal —
    matching the real M-RoPE position assignment.
    """
    embeds = rng.normal(size=(batch, seq, d_model)).astype(np.float32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    n_img = int(seq * img_frac)
    side = max(int(np.sqrt(n_img)), 1)
    pos = np.zeros((batch, seq, 3), np.int32)
    for i in range(n_img):
        pos[:, i] = (0, i // side, i % side)
    text_pos = np.arange(seq - n_img) + side  # text continues after the image
    pos[:, n_img:, 0] = text_pos
    pos[:, n_img:, 1] = text_pos
    pos[:, n_img:, 2] = text_pos
    return {"embeds": embeds, "positions": pos, "labels": labels}
