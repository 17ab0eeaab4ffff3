"""Train an LM end-to-end on the PyTorch port: AdamW + cosine schedule,
remat, checkpoint/restart and the deterministic data pipeline (the
counterpart of ``examples/train_lm.py``).

Default is a fast smoke run; ``--hundred-m`` trains a ~100M-parameter
config for a few hundred steps (the driver is the one the card runs at
full width).  A rerun with the same ``--ckpt-dir`` resumes from its last
checkpoint.

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 60
    PYTHONPATH=src python examples/torch_train_lm.py --hundred-m
"""

import argparse
import dataclasses
from pathlib import Path

from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ARCHS, get_config

CKPT = Path(__file__).resolve().parents[1] / "build" / "lm_ckpt"


def hundred_m_config() -> ModelConfig:
    """~100M-parameter dense config (qwen3-style)."""
    return dataclasses.replace(
        get_config("qwen3-1.7b"),
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab=32_000,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(CKPT))
    ap.add_argument("--hundred-m", action="store_true",
                    help="~100M-param model, a few hundred steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda or cpu (plain PyTorch versions) [cuda]")
    args = ap.parse_args()

    if args.hundred_m:
        import repro_torch.configs.qwen3_1_7b as mod
        cfg = hundred_m_config()
        n = cfg.param_count() / 1e6
        print(f"training ~{n:.0f}M-param model for {max(args.steps, 200)} steps")
        mod.CONFIG = cfg  # the driver reads the registry fresh
        params, losses = train("qwen3-1.7b", smoke=False,
                               steps=max(args.steps, 200), batch=4,
                               seq=256, ckpt_dir=args.ckpt_dir,
                               device=args.device)
    else:
        params, losses = train(args.arch, smoke=True, steps=args.steps,
                               batch=args.batch, seq=args.seq,
                               ckpt_dir=args.ckpt_dir, device=args.device)
    if not losses:
        print(f"nothing left to train: {args.ckpt_dir} holds the last step")
        return
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
