"""End-to-end training driver — the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 50 --batch 32 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --full --steps 4 --batch 8 --seq 512 --microbatches 2 --ckpt CKPT
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --steps 16 --batch 16 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m --reduced --steps 16 --batch 16 \
        --seq 32 --optimizer adafactor --device cpu

``--arch`` takes every config (``repro_torch.configs.ARCH_IDS``: the
dense, MoE and VLM transformers, ``rwkv6-1.6b``, the hybrid
``jamba-1.5-large-398b`` and the audio ``whisper-small``).  A VLM batch
carries zero patch embeddings (batch, ``patch_tokens``, d) in float32, as
the reference's trainer gives it; the loss is taken on the text.  An
audio batch carries frames (batch, ``encoder_frames``, d) drawn in
float32 from ``numpy.random.default_rng(step).normal(0, 1, ...)``, as the
reference's trainer draws them.
The optimizer's state is in ``launch/steps.py::optimizer_tree``'s layout
(Adafactor's stacked over the layers, as the reference's), and a
checkpoint holds it so.

Runs the real loop: synthetic LM data -> micro-batched train step (Q from
--microbatches) -> optimizer -> periodic async checkpoints -> restart from
the latest checkpoint on relaunch.  On the card, attention goes through K2
and K2' and the WKV scan through K3 and K3'.  It runs on ``"cuda"`` unless
the caller passes ``device="cpu"`` (where the kernels' plain versions run);
without a GPU it raises.

Unlike the reference, a restart also resumes the data stream at the
restored step (the stream is a function of the seed, so the batches a run
skips are regenerated): a restarted run then takes the same batches, and
gives the same losses, as an uninterrupted one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.data import token_lm_batches
from repro_torch.launch.steps import init_optimizer, make_train_step
from repro_torch.models.registry import get_model
from repro_torch.optim import get_optimizer


def train(arch: str, *, reduced: bool = True, steps: int = 50,
          batch: int = 32, seq: int = 128, microbatches: int = 4,
          optimizer: str = "adamw", lr: float = 1e-3,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          log_every: int = 10, seed: int = 0, device="cuda") -> list:
    """Train ``arch`` from random weights (seeded) for ``steps`` steps, or
    from the latest checkpoint in ``ckpt_dir`` on; returns the loss of
    each step run."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    api = get_model(cfg, dev)
    opt = get_optimizer(optimizer, lr=lr)
    model = api.init(torch.Generator(device=dev).manual_seed(seed))
    params = dict(model.named_parameters())
    opt_state = init_optimizer(opt, model)
    step0 = 0
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    if store is not None:
        restored, meta = store.restore_latest((params, opt_state),
                                              device=dev)
        if restored is not None:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(restored[0][name])
            opt_state = restored[1]
            step0 = meta["step"] + 1
            print(f"restored checkpoint at step {meta['step']}")

    step_fn = make_train_step(cfg, opt, microbatches, dev)
    data = token_lm_batches(batch=batch, seq_len=seq, vocab=cfg.vocab,
                            seed=seed)
    for _ in range(step0):       # the batches the restored steps took
        next(data)
    losses = []
    t0 = time.time()
    for step in range(step0, steps):
        b = next(data)
        batch_dev = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        if cfg.family == "vlm":
            batch_dev["patch_embeds"] = torch.zeros(
                (batch, cfg.patch_tokens, cfg.d_model), device=dev)
        if cfg.family == "audio":
            batch_dev["frames"] = torch.as_tensor(
                np.random.default_rng(step).normal(
                    0, 1, (batch, cfg.encoder_frames, cfg.d_model)
                ).astype(np.float32), device=dev)
        model, opt_state, loss = step_fn(model, opt_state, batch_dev)
        losses.append(float(loss))
        if step % log_every == 0:
            rate = (step - step0 + 1) / (time.time() - t0)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"{rate:.2f} steps/s", flush=True)
        if store is not None and step % ckpt_every == 0 and step > step0:
            store.save(step, (params, opt_state), blocking=False)
    if store is not None:
        store.save(steps - 1, (params, opt_state), blocking=True)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    losses = train(args.arch, reduced=args.reduced, steps=args.steps,
                   batch=args.batch, seq=args.seq,
                   microbatches=args.microbatches, optimizer=args.optimizer,
                   lr=args.lr, ckpt_dir=args.ckpt, device=args.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
