"""Training launcher: trains a model on the synthetic corpus (port of
``repro/launch/train.py``: the same flags, corpus, batch draws, optimizer
and schedule).

  PYTHONPATH=src python -m repro_torch.launch.train --model tiny-slm \
      --steps 300 --out results/ckpt/tiny-slm.npz

trains the tiny SLM and saves it where ``repro_torch.launch.serve
--ckpt results/ckpt`` (and the reference's ``checkpoint/io.load``) reads
it.  ``--device`` (default ``cuda``) names the card; without one the
launcher raises unless ``--device cpu`` is given.  Parameters come from
``models.model.init_params`` with ``seed``, on the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.synera_pair import tiny_pair
from repro_torch.data.synthetic import SyntheticTask, TaskSpec, batches
from repro_torch.models import model as M
from repro_torch.models.steps import make_train_step
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime import resolve_device


def get_tiny(name: str, vocab: int):
    slm, llm = tiny_pair(vocab=vocab)
    return {"tiny-slm": slm, "tiny-llm": llm}[name]


def train(cfg, *, steps: int = 300, batch_size: int = 16, seq_len: int = 128,
          lr: float = 3e-3, seed: int = 0, corpus=None, log_every: int = 50,
          ckpt_path: str | None = None, device=None):
    """Train ``cfg`` from ``init_params(cfg, seed)`` for ``steps`` AdamW
    steps on batches drawn from ``corpus`` (default: the synthetic task's
    64 x 2048-token corpus from ``seed``).  Returns (params, per-step
    losses); saves the parameters to ``ckpt_path`` when given."""
    dev = resolve_device(device)
    task = SyntheticTask(TaskSpec(vocab=cfg.vocab))
    if corpus is None:
        corpus, _ = task.corpus(n_sequences=64, length=2048, seed=seed)
    params = M.init_params(cfg, seed, device=dev)
    opt = AdamW(lr=lr, schedule=cosine_schedule(lr, warmup=20, total=steps),
                weight_decay=0.01)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)

    it = batches(corpus, batch_size, seq_len,
                 rng=np.random.default_rng(seed + 1))
    t0 = time.time()
    losses = []
    for step in range(steps):
        batch = {"tokens": torch.as_tensor(next(it), device=dev)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if log_every and (step + 1) % log_every == 0:
            print(f"  step {step + 1:5d} loss "
                  f"{np.mean(losses[-log_every:]):.4f} "
                  f"({(time.time() - t0) / (step + 1) * 1e3:.0f} ms/step)",
                  flush=True)
    if ckpt_path:
        ckpt.save(ckpt_path, params)
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny-slm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; raises "
                         "without a card unless 'cpu' is given)")
    args = ap.parse_args(argv)
    cfg = get_tiny(args.model, args.vocab)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"({cfg.param_count()/1e6:.1f}M params)")
    train(cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
          lr=args.lr, ckpt_path=args.out or f"results/ckpt/{cfg.name}.npz",
          device=args.device)


if __name__ == "__main__":
    main()
