"""Roofline from the dry run's records — the counterpart of
``repro/launch/roofline.py``, at an H100's data-sheet constants.

Per (arch x shape x mesh) cell, from ``results/dryrun_torch/*.json``
(``launch/dryrun.py``):

  compute term    = FLOPs_dev / peak_FLOPs            [s]
  memory term     = HBM_bytes_dev / HBM_bw            [s]
  collective term = coll_bytes_dev / link_bw          [s]

FLOPs and collective bytes are what one rank runs (``utils/cost.py``).
The constants are ``core/network.py``'s: the bf16 tensor-core peak, HBM3's
rate, and for the collective term NDR InfiniBand's rate a GPU, since the
production meshes' 256 or 512 ranks span nodes of 8 (NVLink joins only
the 8 of a node).  :func:`roofline_row` takes them as keywords, so the
reference's TPU constants give the reference's rows.

Also reported per cell: the dominant term, MODEL_FLOPS = 6 N_active D
(train) / 2 N_active D (prefill / decode), the usefulness ratio
MODEL / counted, and a one-line note on what would move the dominant term.
Every figure here is a prediction from shapes and data-sheet constants:
no card measured it.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import arch_profile
from repro_torch.core.network import (H100_HBM_BW, H100_HBM_BYTES,
                                      H100_IB_BW, H100_PEAK_FLOPS)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def active_params(arch: str) -> float:
    """N_active: parameters touched per token (MoE: top_k of E experts)."""
    cfg = get_config(arch)
    if cfg.moe_experts:
        # expert params scale by top_k / E for the active count
        cfg = dataclasses.replace(cfg, moe_experts=cfg.moe_top_k)
    return float(arch_profile(cfg).param_cum()[-1]) / 4.0


def model_flops(arch: str, shape: str, tokens: int | None = None) -> float:
    """6 N_active D for a train shape, else 2 N_active D; ``tokens`` (D)
    replaces the shape's own count for a cell traced at another batch."""
    sp = SHAPES[shape]
    n = active_params(arch)
    if tokens is None:
        tokens = sp.global_batch * (1 if sp.kind == "decode"
                                    else sp.seq_len)
    factor = 6.0 if sp.kind == "train" else 2.0
    return factor * n * tokens


def model_traffic_bytes(rec: dict) -> float:
    """Analytic per-device HBM traffic of the step (weights, optimizer,
    activations and caches at their dtypes, spread over the chips, plus
    the rank's arguments and outputs), as the reference models it; the
    counted traffic (``bytes_per_device``) stays a diagnostic upper
    bound.  A record traced at another batch than its shape's carries its
    ``tokens``."""
    cfg = get_config(rec["arch"])
    sp = SHAPES[rec["shape"]]
    chips = rec.get("devices", 256)
    n_params = float(arch_profile(cfg).param_cum()[-1]) / 4.0
    L = cfg.num_layers + 2
    act_touch = 8.0                      # residual-stream touches per layer
    if sp.kind == "train":
        tokens = rec.get("tokens", sp.global_batch * sp.seq_len)
        opt_mult = {"adamw": 24.0, "adafactor": 10.0, "momentum": 12.0,
                    "sgd": 8.0}.get(rec.get("optimizer", "adamw"), 24.0)
        weights = 3 * 4.0 * n_params + opt_mult * n_params
        acts = L * tokens * cfg.d_model * 2.0 * act_touch * 2.0   # fwd+bwd
        vocab = tokens * cfg.vocab * 2.0 * 3.0
        whole = weights + acts + vocab
    elif sp.kind == "prefill":
        tokens = rec.get("tokens", sp.global_batch * sp.seq_len)
        whole = 2.0 * n_params + L * tokens * cfg.d_model * 2.0 * act_touch
    else:  # decode: weights + full cache read dominate; args ~= both
        whole = 0.0
    per_dev = whole / chips
    m = rec.get("memory", {})
    per_dev += float(m.get("argument_size_in_bytes", 0)) \
        + float(m.get("output_size_in_bytes", 0))
    return per_dev


def roofline_row(rec: dict, *, peak_flops: float = H100_PEAK_FLOPS,
                 hbm_bw: float = H100_HBM_BW, link_bw: float = H100_IB_BW,
                 fit_bytes: float = H100_HBM_BYTES) -> dict:
    chips = rec.get("devices", 256)
    comp = rec["flops_per_device"] / peak_flops
    mem = model_traffic_bytes(rec) / hbm_bw
    mem_counted = rec["bytes_per_device"] / hbm_bw
    coll = rec["collective_bytes_per_device"] / link_bw
    terms = {"compute": comp, "memory": mem, "collective": coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"], rec.get("tokens"))
    counted = rec["flops_per_device"] * chips
    useful = mf / counted if counted else 0.0
    bound = max(terms.values())
    frac = (mf / peak_flops / chips) / bound if bound else 0.0
    notes = {
        "compute": "reduce redundant/remat FLOPs or raise arithmetic "
                   "intensity (fuse, larger tiles)",
        "memory": "keep activations in bf16, increase reuse per HBM read "
                  "(bigger microbatch / fused layers)",
        "collective": "cut per-layer psum volume (bf16 collectives, "
                      "2D sharding, overlap with compute)",
    }
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": comp, "memory_s": mem, "memory_hlo_s": mem_counted,
        "collective_s": coll,
        "dominant": dominant,
        "model_flops": mf, "hlo_flops": counted,
        "useful_ratio": useful,
        "roofline_fraction": frac,
        "hbm_gib": rec["hbm_per_device"] / 2**30,
        "fits": rec.get("fits_80gb", rec["hbm_per_device"] < fit_bytes),
        "note": notes[dominant],
    }


def load_records(result_dir: str, tag: str = "") -> list:
    rows = []
    for f in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        base = os.path.basename(f)[:-5]
        parts = base.split("__")
        if tag and not base.endswith(tag):
            continue
        if not tag and len(parts) == 3 and "_" in parts[2] and \
                parts[2].split("_", 1)[1] not in ("pipe",):
            # tagged perf-iteration files are excluded from the baseline table
            if parts[2] not in ("single", "multi"):
                continue
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def markdown_table(rows: list) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | roofline frac | HBM GiB | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['hbm_gib']:.2f} | {'Y' if r['fits'] else 'N'} |")
    return hdr + "\n".join(lines)


def _cell_key(rec: dict) -> tuple:
    return rec["arch"], rec["shape"], rec["mesh"], rec.get("kind")


def compare_table(recs: list, refs: list) -> str:
    """The port's records beside the reference's (``repro/launch/
    dryrun.py``'s JSON files) of the same cells: FLOPs a device and their
    ratio, HBM a device, and each side's seconds to trace or compile; a
    cell the reference did not lower shows "—" there."""
    by_key = {_cell_key(r): r for r in refs}
    hdr = ("| arch | shape | mesh | FLOPs port | FLOPs reference | port / "
           "reference | HBM GiB port | HBM GiB reference | s port | "
           "s reference |\n|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(recs, key=_cell_key):
        ref = by_key.get(_cell_key(r))
        port = (f"{r['flops_per_device']:.4e}",
                f"{r['hbm_per_device'] / 2**30:.2f}")
        if ref is None:
            theirs = ("—", "—", "—", "—")
        else:
            ratio = r["flops_per_device"] / ref["flops_per_device"] \
                if ref["flops_per_device"] else float("nan")
            theirs = (f"{ref['flops_per_device']:.4e}", f"{ratio:.4f}",
                      f"{ref['hbm_per_device'] / 2**30:.2f}",
                      f"{ref['lower_compile_seconds']}")
        mesh = r["mesh"] + (" pipe" if r.get("kind") == "train-pipeline"
                            else "")
        lines.append(f"| {r['arch']} | {r['shape']} | {mesh} | {port[0]} "
                     f"| {theirs[0]} | {theirs[1]} | {port[1]} | {theirs[2]} "
                     f"| {r['lower_compile_seconds']} | {theirs[3]} |")
    return hdr + "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--reference", default=None,
                    help="a directory of the reference's dry-run records "
                    "(python -m repro.launch.dryrun --out DIR) to print "
                    "beside the port's")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    rows = [roofline_row(r) for r in recs]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print("Predicted from the dry run's counts and H100 data-sheet "
          "constants (989 TFLOP/s bf16, 3.35 TB/s HBM3, 50 GB/s InfiniBand "
          "a GPU); no card measured these.")
    print(markdown_table(rows))
    if args.reference:
        print("\nThe port's dry run beside the reference's (both "
              "predictions from shapes: the reference's XLA compile on host "
              "devices, the port's trace on fake tensors).")
        print(compare_table(recs, load_records(args.reference)))
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)


if __name__ == "__main__":
    main()
