"""Token pipeline for LM training (the port of ``repro.data.tokens``):
deterministic synthetic batches (step → batch is a pure numpy function,
so a restore is exact and the batches equal the JAX package's bit for
bit), plus the suffix-tree-backed dedup filter — ERA's index applied to
the training data path (exact substring dedup over the token stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.alphabet import DNA
from repro_torch.core.api import EraConfig, EraIndexer


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0


def batch_at_step(cfg: TokenPipelineConfig, step: int) -> dict:
    """Pure function step -> batch (numpy int32); restart-safe by
    construction."""
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    tokens = rng.integers(0, cfg.vocab, size=(cfg.batch, cfg.seq_len + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def dedup_mask(sequences: np.ndarray, *, min_repeat: int = 32,
               mem_budget: int = 1 << 16, device="cuda") -> np.ndarray:
    """ERA-backed exact-repeat detection over a token batch.

    Maps token ids into a small code alphabet (ids mod |Σ|), indexes the
    concatenated stream with the ERA suffix tree on ``device``, and flags
    sequences whose content contains a repeated run of >= ``min_repeat``
    symbols appearing elsewhere in the batch.  Returns keep-mask (True =
    keep).  The walk is the JAX package's: the sub-trees in its order (the
    owner bookkeeping depends on it), and the leaf before the first of a
    sub-tree is numpy's ``ell[-1]``, its last.
    """
    b, s = sequences.shape
    codes = (sequences % len(DNA.symbols)).astype(np.uint8)
    flat = np.concatenate([codes.reshape(-1), [DNA.terminal_code]]).astype(np.uint8)
    idx = EraIndexer(DNA, EraConfig(memory_bytes=mem_budget, r_bytes=4096,
                                    build_impl="none"),
                     device=device).build(flat)
    keep = np.ones(b, dtype=bool)
    seen_owner: dict[tuple, int] = {}
    for prefix, st in idx.subtrees.items():
        # deep duplicated paths = long exact repeats: b_off >= min_repeat
        deep = np.asarray(st.b_off) >= min_repeat
        for i in np.nonzero(deep)[0]:
            for pos in (int(st.ell[i - 1]), int(st.ell[i])):
                owner = pos // s
                key = prefix
                if key in seen_owner and seen_owner[key] != owner and 0 <= owner < b:
                    keep[owner] = False
                else:
                    seen_owner[key] = owner
    return keep
