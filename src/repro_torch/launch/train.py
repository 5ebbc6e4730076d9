"""Training launcher: an LM architecture on the local device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --steps 3 --device cpu

The JAX package's launcher with its flags (``--arch``, ``--steps``,
``--batch``, ``--seq-len``, ``--full-config``, ``--ckpt-dir``,
``--compress-grads``) and ``--device``: the card by default, as every entry
point of the port.  Without ``--full-config`` it trains
``reduced_for_port()`` (``reduced()`` with the attention kernel's smallest
head size).  The model is qwen3-style parameters from seed 0, AdamW on a
cosine schedule, the ``Trainer`` loop; the update writes into the
parameters and the optimizer state in place, and ``--full-config``
recomputes each layer in the backward (remat), which is what fits a 4B
model's weights, gradients and float32 AdamW state on one 80 GB card.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils import get_logger

log = get_logger("launch.train")


def build_trainer(arch: str = "qwen3-4b", steps: int = 100, batch: int = 8,
                  seq_len: int = 128, full_config: bool = False,
                  ckpt_dir: Optional[str] = None, compress: bool = False,
                  device=None, checkpoint_every: int = 50) -> Trainer:
    """The launcher's ``Trainer``, ready to ``run()``: parameters from seed
    0 on ``device`` (default the card), ``TokenPipeline`` batches from seed
    0, remat with ``full_config``; ``ckpt_dir`` defaults to ``repro_train``
    in the temporary directory."""
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.models import transformer as tf

    cfg = get_config(arch)
    if cfg.family != "lm":
        raise SystemExit("launch.train drives LM archs; DLRM and GNN training run "
                         "through their models' make_train_step")
    if not full_config:
        cfg = cfg.reduced_for_port()
    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_train")

    params = tf.init(cfg, seed=0, device=dev)
    opt = AdamW(learning_rate=cosine_schedule(1e-3, 20, steps))
    ostate = opt.init(params)
    step = tf.make_train_step(cfg, opt, remat=full_config)
    data = TokenPipeline(cfg.vocab, batch, seq_len, seed=0)

    def loss_and_grads(params, batch):
        (loss, metrics), grads = tf.value_and_grad(params, batch, cfg, full_config)
        return grads, metrics

    return Trainer(
        TrainerConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                      checkpoint_dir=ckpt_dir, compress_grads=compress),
        step, params, ostate, data,
        grad_step_fn=loss_and_grads,
        apply_fn=lambda p, g, o: opt.update(p, g, o, inplace=True),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (assignment) config instead of reduced")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_train in the temporary "
                         "directory)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run here)")
    args = ap.parse_args(argv)

    trainer = build_trainer(args.arch, args.steps, args.batch, args.seq_len,
                            args.full_config, args.ckpt_dir, args.compress_grads,
                            args.device)
    trainer.try_resume()
    out = trainer.run()
    log.info("done: final loss %.4f", out["metrics"][-1]["loss"])


if __name__ == "__main__":
    main()
