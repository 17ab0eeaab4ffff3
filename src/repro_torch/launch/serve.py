"""Batched LM serving: prefill a batch of prompts, then decode
greedily (the port of ``repro.launch.serve``).

CPU example (smoke model):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch qwen3-1.7b --batch 4 --prompt-len 32 --gen 16

Every family runs: dense, vlm, moe (GQA or MLA), ssm, hybrid and
encdec.  On the card (the default device), a prefill's global
self-attention from the empty cache runs the hand-written
``flash_attention`` kernel (causal), and so does the encdec encoder's
bidirectional attention (its full mode).  As in the JAX CLI,
``--smoke`` is on and cannot be switched off from the command line; the
full-width model is ``serve(arch, smoke=False)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch import steps as step_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import get_config


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, dtype=torch.float32,
          seed: int = 0, device="cuda"):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (from
    ``np.random.default_rng(seed)``, as ``repro.launch.serve`` draws
    them), then decode ``gen`` tokens greedily.  Returns (tokens int32
    (batch, gen), {"t_prefill_s", "t_decode_s", "decode_tok_s"}); on the
    card each clock read follows a ``torch.cuda.synchronize``."""
    dev = ops.resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)

    params = T.init_params(0, cfg, dtype, dev)
    rng = np.random.default_rng(seed)
    max_len = prompt_len + gen + 1

    batch_in = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(batch, prompt_len), dtype=np.int32)
    ).to(dev)}
    if cfg.family == "encdec" or cfg.frontend:
        batch_in["frontend"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.frontend_len, cfg.frontend_dim))
        ).to(dev, dtype)

    cache = T.init_cache(cfg, batch, max_len, dtype=dtype, device=dev)
    prefill = step_lib.make_prefill_step(cfg)
    decode = step_lib.make_decode_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch_in, cache)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    sync()
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1)
    return tokens, {"t_prefill_s": t_prefill, "t_decode_s": t_decode,
                    "decode_tok_s": batch * (gen - 1) / max(t_decode, 1e-9)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: hand kernels) or cpu (plain "
                         "PyTorch versions)")
    args = ap.parse_args()
    tokens, stats = serve(args.arch, smoke=args.smoke, batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          device=args.device)
    print("generated:", tokens.cpu().numpy()[:, :8], "...")
    print(stats)


if __name__ == "__main__":
    main()
