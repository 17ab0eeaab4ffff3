"""End-to-end LM training driver (the port of ``repro.launch.train``).

AdamW + cosine schedule, remat, checkpoint/restore with atomic commits,
the deterministic restart-safe token pipeline.  It trains every
decoder-only family (dense, moe with GQA or MLA, ssm, hybrid) and refuses
the encdec and frontend archs as the JAX driver does.  ``--mesh prod`` /
``multipod`` build the production mesh first
(:func:`repro_torch.launch.mesh.make_production_mesh`), which fails as
JAX's does on a world of fewer ranks; on a mesh, as in the JAX driver
(which computes the parameter shardings and jits its step without them),
each rank runs the one-device step.  The log lines, the returned losses
and the checkpoint files are the JAX driver's.

Example (CPU, smoke model):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-1.7b --steps 300 --batch 8 --seq 128
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
from repro_torch.kernels import ops
from repro_torch.launch import steps as step_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw
from repro_torch.runtime import checkpoint


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    resume: bool = True,
    mesh=None,
    dtype=torch.float32,
    log_every: int = 10,
    device="cuda",
):
    """Train ``arch`` for ``steps`` steps on ``device``; returns (params,
    losses), the losses of the logged steps.  ``mesh`` is None, ``"host"``
    or a DeviceMesh; the step is the one-device program on each.  The
    parameters and moments are updated in place each step; on the card
    every clock read follows a ``torch.cuda.synchronize``."""
    if isinstance(mesh, str) and mesh != "host":
        raise ValueError(f"mesh {mesh!r}: pass a DeviceMesh "
                         "(make_production_mesh) or 'host'")
    dev = ops.resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if cfg.family == "encdec" or cfg.frontend:
        raise SystemExit("train driver targets decoder-only archs; "
                         "see examples/ for the others")

    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(10, steps // 20))
    pipe = TokenPipelineConfig(vocab=cfg.vocab, batch=batch, seq_len=seq)

    params = T.init_params(0, cfg, dtype, dev)
    opt_state = adamw.init(params)
    start_step = 0

    if ckpt_dir and resume:
        latest = checkpoint.latest_step_path(ckpt_dir)
        if latest:
            (params, opt_state), meta = checkpoint.restore(latest, (params, opt_state))
            start_step = int(meta.get("step", 0))
            print(f"resumed from {latest} at step {start_step}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    train_step = step_lib.make_train_step(cfg, opt_cfg, donate=True)
    losses = []
    sync()
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        batch_np = batch_at_step(pipe, step)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        params, opt_state, metrics = train_step(params, opt_state, batch_dev)
        if (step + 1) % log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            losses.append(loss)
            sync()
            tok_s = pipe.batch * pipe.seq_len * log_every / max(1e-9, time.perf_counter() - t0)
            print(f"step {step+1:5d}  loss {loss:.4f}  gnorm "
                  f"{float(metrics['grad_norm']):.3f}  tok/s {tok_s:,.0f}", flush=True)
            t0 = time.perf_counter()
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            path = f"{ckpt_dir}/step_{step+1}.npz"
            checkpoint.save(path, (params, opt_state), step=step + 1,
                            meta={"arch": arch})
    return params, losses


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's flags (names, defaults, choices) and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", choices=["host", "prod", "multipod"], default="host")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = {"host": lambda: "host",
            "prod": lambda: make_production_mesh(device=args.device),
            "multipod": lambda: make_production_mesh(
                multi_pod=True, device=args.device)}[args.mesh]()
    train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
          seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir, mesh=mesh,
          device=args.device)


if __name__ == "__main__":
    main()
