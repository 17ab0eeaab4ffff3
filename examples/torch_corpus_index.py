"""ERA inside the LM data path on the PyTorch port: exact-substring dedup
of a token stream (the counterpart of ``examples/corpus_index.py``).

The generalized suffix tree over a token batch finds long exact repeats in
one pass — the indexing engine applied to training-data hygiene; on the
card its construction reads through the hand-written gather kernels.

    PYTHONPATH=src python examples/torch_corpus_index.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step, dedup_mask


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda or cpu (plain PyTorch versions) [cuda]")
    args = ap.parse_args()

    cfg = TokenPipelineConfig(vocab=32_000, batch=16, seq_len=256, seed=0)
    batch = batch_at_step(cfg, 0)
    seqs = batch["tokens"].copy()

    # plant contamination: three sequences share a 128-token block
    seqs[5, 50:178] = seqs[2, 50:178]
    seqs[11, 0:128] = seqs[2, 50:178]

    keep = dedup_mask(seqs, min_repeat=64, device=args.device)
    flagged = np.nonzero(~keep)[0].tolist()
    print(f"batch of {len(seqs)}: flagged duplicates at rows {flagged}")
    assert len(flagged) >= 1
    print(f"kept {int(keep.sum())}/{len(seqs)} sequences")


if __name__ == "__main__":
    main()
