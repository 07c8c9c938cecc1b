"""Where a served request's time goes: one prefill and a run of greedy
decode steps of the server's model, each under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --full
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch qwen3-0.6b --full
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch llama3-8b --full
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch granite-moe-3b-a800m --full
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch whisper-small --full --prompt-len 64
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch jamba-1.5-large-398b --full --layers 2 --attn-every 2

``--arch`` takes every ported config (``repro_torch.configs.ARCH_IDS``).
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --device cpu

Each window runs twice: once timed on the host clock (ending in a device
synchronise), then once under the profiler, whose tracing slows the host
but not the kernels.  For each window it prints one JSON line: the
unprofiled wall time, the device's busy time (the sum of its kernels'
durations in the profiled run; the server runs on one stream, so they do
not overlap), the device's idle share (1 - busy / unprofiled wall), the
number of kernels, the kernels that took the most device time, and the
launches of the port's own kernels (K2 ``flash_attention``, K3 ``wkv6``)
in the timed run with their device time in the profiled one.  Off the card the device fields are null.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.rwkv6 import wkv6
from repro_torch.launch.serve import BatchedServer

#: the port's kernels on the serving paths, by the name a window reports
KERNELS = {"flash_attention": flash_attention, "wkv6": wkv6}
#: what their CUDA kernels' names contain (K3 launches two a call)
KERNEL_NAMES = {"flash_attention": "flash_fwd", "wkv6": "wkv6_"}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profiled(fn, dev, top: int = 8):
    """Run ``fn()`` timed, then again under the profiler; returns (the
    first run's result, the window's numbers)."""
    on_card = dev.type == "cuda"
    _sync(dev)
    before = {name: k.launches for name, k in KERNELS.items()}
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: k.launches - before[name] for name, k in KERNELS.items()}
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        fn()
        _sync(dev)
    kernel_us = collections.Counter()
    kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel_us[e.name] += e.time_range.elapsed_us()
            kernels += 1
    busy_ms = sum(kernel_us.values()) / 1e3
    return out, {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if on_card else None,
        "kernels": kernels if on_card else None,
        "top_kernels_ms": [[name[:80], us / 1e3]
                           for name, us in kernel_us.most_common(top)],
        "launches": launches,
        "kernel_ms": {name: sum(us for k, us in kernel_us.items()
                                if part in k) / 1e3
                      for name, part in KERNEL_NAMES.items()}
        if on_card else None,
    }


def profile_serve(arch: str = "rwkv6-1.6b", *, reduced: bool = True,
                  prompt_len: int = 512, steps: int = 16, seed: int = 0,
                  device="cuda", config=None) -> dict:
    """Profile one prefill of ``prompt_len`` tokens (after a VLM's patch
    embeddings, an audio model's frames) and ``steps`` greedy decode steps
    after it from the server's ``pos`` (one request, as the server runs
    each slot), after one warm-up of each (the weights' casts, library
    handles).  ``config`` is served in place of the arch's (a cut)."""
    cfg = config or get_config(arch, reduced=reduced)
    srv = BatchedServer(arch, reduced=reduced, batch=1, seed=seed,
                        cache_len=prompt_len + steps + 1 + cfg.patch_tokens,
                        device=device, config=cfg)
    dev, api, model = srv.device, srv.api, srv.params
    rng = np.random.default_rng(seed)
    batch = srv.prefill_batch(rng.integers(0, srv.cfg.vocab,
                                           size=prompt_len))
    tokens = batch["tokens"]
    _, state = api.prefill(model, batch, srv.cache_len)
    api.decode(model, state, tokens[:, :1], prompt_len)

    (logits, state), prefill = profiled(
        lambda: api.prefill(model, batch, srv.cache_len), dev)

    def decode_steps():
        nonlocal logits, state
        for t in range(steps):       # the profiled run goes on from here
            tok = int(torch.argmax(logits[0, -1]))
            logits, state = api.decode(
                model, state, torch.tensor([[tok]], device=dev),
                prompt_len + t)

    _, decode = profiled(decode_steps, dev)
    decode["tokens_per_s"] = steps / (decode["wall_ms"] / 1e3)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    return {"arch": srv.cfg.name, "device": str(dev), "card": card,
            "prompt_len": prompt_len, "steps": steps,
            "prefill": prefill, "decode": decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--full", action="store_true",
                    help="the full-size config (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--attn-every", type=int, default=None,
                    help="a hybrid's period (with --layers)")
    args = ap.parse_args(argv)
    changes = {k: v for k, v in (("num_layers", args.layers),
                                 ("attn_every", args.attn_every))
               if v is not None}
    config = dataclasses.replace(get_config(args.arch,
                                            reduced=not args.full),
                                 **changes)
    out = profile_serve(args.arch, reduced=not args.full,
                        prompt_len=args.prompt_len, steps=args.steps,
                        device=args.device, config=config)
    for phase in ("prefill", "decode"):
        print(json.dumps({"window": phase, "arch": out["arch"],
                          "device": out["device"], "card": out["card"],
                          **out[phase]}))


if __name__ == "__main__":
    main()
