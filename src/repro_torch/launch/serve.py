"""Batched serving driver: continuous-batching decode loop.

The port of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 4 --prompt-len 16 --gen 8           # reduced, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --prompt-len 512 --gen 32 --cache-len 1024     # qwen3-0.6b, on a GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --full --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --full --prompt-len 512 --gen 32 --cache-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch command-r-35b --full --layers 8 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --full --prompt-len 512 --gen 32 \
        --cache-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-235b-a22b --full --layers 4 --prompt-len 512 \
        --gen 32 --cache-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \
        --full --prompt-len 512 --gen 32 --cache-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --full --prompt-len 64 --gen 64 --cache-len 448
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --full --layers 2 --attn-every 2 \
        --prompt-len 512 --gen 32 --cache-len 1024

``--arch`` takes every config (``repro_torch.configs.ARCH_IDS``: the dense
``qwen3-0.6b``, ``llama3-8b``, ``qwen1.5-4b`` and ``command-r-35b``, the
MoE ``granite-moe-3b-a800m`` and ``qwen3-moe-235b-a22b``, the VLM
``internvl2-1b``, ``rwkv6-1.6b``, the hybrid ``jamba-1.5-large-398b`` and
the audio ``whisper-small``).  A request queue, a prefill of each admitted
request into its own single-row state (the KV cache of a transformer, the
recurrent state of ``rwkv6-1.6b``, Jamba's KV cache and Mamba states,
Whisper's self- and cross-attention caches), then a decode loop that
retires finished sequences and admits new ones into the freed slots
(continuous batching); greedy sampling (``argmax``, the first index on
ties).  Admission, retirement and the returned stats are the reference's.
The server runs on ``"cuda"`` unless the caller passes ``device="cpu"``;
without a GPU it raises.

A VLM request's prefill takes zero patch embeddings (1, ``patch_tokens``,
d) in the compute type before its prompt, as the reference's server does.
Like the reference's, the server then decodes from ``pos =
len(prompt)``, which leaves the ``patch_tokens`` patch positions out: the
first decode step writes into cache slot ``len(prompt)``, over a prompt
token's keys, and attends over the slots up to it.  The port keeps this
for parity (ROADMAP Queue 3); the model itself decodes right at ``pos =
patch_tokens + len(prompt)``.  An audio request's prefill takes zero
frames (1, ``encoder_frames``, d) in the compute type, as the reference's
server does.

A config too large for one card is served cut: ``num_layers`` cuts the
depth (``command-r-35b`` at 8 of its 40 layers, ``qwen3-moe-235b-a22b`` at
4 of its 94), and ``config`` stands in for the arch lookup when more than
the depth changes.  ``jamba-1.5-large-398b`` is served at full width cut to
one period of 2 layers, ``dataclasses.replace(CONFIG, num_layers=2,
attn_every=2)``: a Mamba + SwiGLU slot and an attention + MoE slot (16
experts of 8192 x 24576, top 2), every slot kind at its published widths.
One published period (8 layers, 4 with experts) holds 45,238,345,728
parameters, 181 GB in float32 and 90.5 GB in bfloat16, more than an 80 GB
card; the 2-layer period holds 11,912,896,512, 47.65 GB in float32, and
with the bfloat16 casts the server keeps about 71.5 GB (66.6 GiB).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import get_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """``num_layers`` cuts the config's depth (its widths unchanged): a
    model whose full depth does not fit one card, such as
    ``command-r-35b``, is served at the layers that do.  ``config``, when
    given, is served in place of ``get_config(arch, reduced)`` (a hybrid
    cut below one period changes ``attn_every`` as well)."""

    def __init__(self, arch: str, *, reduced: bool = True, batch: int = 4,
                 cache_len: int = 128, seed: int = 0, device="cuda",
                 params=None, num_layers: int | None = None,
                 config: ArchConfig | None = None):
        self.device = resolve_device(device)
        self.cfg = config or get_config(arch, reduced=reduced)
        if num_layers is not None:
            self.cfg = dataclasses.replace(self.cfg, num_layers=num_layers)
        self.api = get_model(self.cfg, self.device)
        self.batch = batch
        self.cache_len = cache_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init(gen)
        self.params = params
        self.decode = self.api.decode
        self.queue: list = []
        self.slots: list = [None] * batch

    def submit(self, req: Request):
        self.queue.append(req)

    def prefill_batch(self, prompt) -> dict:
        """The prefill's batch for one prompt (P,): its tokens (1, P) and,
        for a VLM, zero patch embeddings, for an audio model zero frames,
        in the compute type."""
        batch = {"tokens": torch.as_tensor(np.asarray(prompt)[None, :],
                                           device=self.device)}
        if self.cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (1, self.cfg.patch_tokens, self.cfg.d_model),
                dtype=self.cfg.compute_dtype, device=self.device)
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (1, self.cfg.encoder_frames, self.cfg.d_model),
                dtype=self.cfg.compute_dtype, device=self.device)
        return batch

    def _prefill_one(self, req: Request):
        """Prefill a single request into a fresh single-row state."""
        logits, cache = self.api.prefill(
            self.params, self.prefill_batch(req.prompt), self.cache_len)
        tok = int(torch.argmax(logits[0, -1]))
        return tok, cache, len(req.prompt)

    def run(self, *, max_ticks: int = 1000) -> dict:
        """Continuous batching: admit from queue, decode, retire."""
        stats = {"ticks": 0, "completed": [], "tokens": 0}
        t0 = time.time()
        for _ in range(max_ticks):
            # admit
            for i in range(self.batch):
                if self.slots[i] is None and self.queue:
                    req = self.queue.pop(0)
                    tok, cache, pos = self._prefill_one(req)
                    req.generated.append(tok)
                    self.slots[i] = {"req": req, "cache": cache, "pos": pos,
                                     "last": tok}
            live = [s for s in self.slots if s is not None]
            if not live:
                break
            # decode each live slot (row-batched per slot: states are per
            # slot so heterogeneous positions are exact)
            for s in live:
                token = torch.tensor([[s["last"]]], dtype=torch.int32,
                                     device=self.device)
                logits, s["cache"] = self.decode(self.params, s["cache"],
                                                 token, s["pos"])
                s["last"] = int(torch.argmax(logits[0, -1]))
                s["pos"] += 1
                s["req"].generated.append(s["last"])
                stats["tokens"] += 1
            # retire
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                req = s["req"]
                if (len(req.generated) >= req.max_new
                        or s["pos"] >= self.cache_len - 1):
                    req.done = True
                    stats["completed"].append(req)
                    self.slots[i] = None
            stats["ticks"] += 1
        stats["seconds"] = time.time() - t0
        stats["tok_per_s"] = stats["tokens"] / max(stats["seconds"], 1e-9)
        return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the full-size config (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--attn-every", type=int, default=None,
                    help="a hybrid's period (with --layers, to cut it "
                    "below one published period)")
    args = ap.parse_args(argv)
    config = None
    if args.attn_every is not None:
        config = dataclasses.replace(
            get_config(args.arch, reduced=not args.full),
            attn_every=args.attn_every)
    srv = BatchedServer(args.arch, reduced=not args.full, batch=args.batch,
                        cache_len=args.cache_len, device=args.device,
                        num_layers=args.layers, config=config)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        srv.submit(Request(rid, rng.integers(
            0, srv.cfg.vocab, size=args.prompt_len).astype(np.int32),
            max_new=args.gen))
    stats = srv.run()
    print(f"served {len(stats['completed'])} requests, "
          f"{stats['tokens']} tokens in {stats['seconds']:.1f}s "
          f"({stats['tok_per_s']:.1f} tok/s) on {srv.device}")


if __name__ == "__main__":
    main()
