"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs the paper's plan-and-train loop through ``repro_torch`` on the card,
in phases; any failure raises and exits non-zero:

  1. device  require CUDA; print the card's name and power limit
  2. build   build the min-plus kernel K1 from the checkout's sources
  3. kernel  hold K1 against its plain PyTorch version on the card, at the
             thresholds Algorithm 1 sweeps on the quickstart instance
             (VGG-16, 6 servers + 4 clients) and on a fleet instance
             (48 servers x 30 layers): float64 bitwise equal, float32
             within rtol 1e-4 with matching finite masks, both modes
  4. plan    ours(B=512, b0=20) on cuda equals the same call on the CPU
             (cuts, placement, b, T_f, T_i, L_t) and launched K1;
             no_pipeline and the Eq. (14) event-simulation gap
  5. train   one VGG-16 round on cuda matches the CPU (TF32 off); then a
             few rounds at the B=512 plan, timed

The next-to-last line is a JSON object with K1's measurements; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package ``repro``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

#: H100 SXM peaks (NVIDIA data sheet; dense, no sparsity, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float64: 34e12, torch.float32: 67e12}   # non-tensor-core
F32_RTOL = 1e-4
LOSS_RTOL = 1e-4


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, min_seconds: float = 0.2) -> float:
    """Mean device time of ``fn`` over repeated launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(1000, int(min_seconds / max(time.perf_counter() - t0,
                                                   1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def recording_sweeps(shortest_path):
    """Record every K1 call Algorithm 1 makes (its actual inputs)."""
    calls = []
    real = shortest_path.sweep_minplus

    def record(*args, **kw):
        calls.append((args, kw.get("mode", "sum")))
        return real(*args, **kw)

    shortest_path.sweep_minplus = record
    try:
        yield calls
    finally:
        shortest_path.sweep_minplus = real


def layers_run(args, mode) -> torch.Tensor:
    """Layers K1 runs per threshold: it stops after the first layer whose
    dist is all-inf (work that depends on the data, counted as it is)."""
    Cc, Bc, Ss, Bs, sc, sb, K, ts = args
    inf = torch.tensor(math.inf, dtype=Cc.dtype, device=Cc.device)
    op = torch.add if mode == "sum" else torch.maximum
    t4 = ts[:, None, None, None]
    Vc = torch.where(Bc <= t4, Cc if mode == "sum" else Bc, inf)
    Vs = torch.where(Bs <= t4, Ss if mode == "sum" else Bs, inf)
    dist = torch.full((ts.shape[0],) + tuple(Cc.shape[:2]), math.inf,
                      dtype=Cc.dtype, device=Cc.device)
    dist[:, 0] = torch.where(sb <= ts[:, None], sc if mode == "sum" else sb,
                             inf)
    alive = torch.ones(ts.shape[0], dtype=torch.bool, device=Cc.device)
    count = torch.zeros(ts.shape[0], dtype=torch.long, device=Cc.device)
    for _ in range(2, K + 1):
        count += alive
        dist = op(op(dist[..., None], Vc).amin(1)[..., None], Vs).amin(1)
        alive &= torch.isfinite(dist).flatten(1).any(1)
    return count


def bound_ms(args, mode, dtype) -> tuple:
    """(bound_ms, bound_by): each input read once and the output written
    once over HBM bandwidth, vs the operations these inputs need (a
    compare-select per edge per threshold to fold the mask, then an
    (+ or max) and a min per candidate per layer run) over the dtype's
    non-tensor-core peak."""
    Cc, Bc, Ss, Bs, sc, sb, K, ts = args
    esize = torch.tensor([], dtype=dtype).element_size()
    elems = 2 * Cc.numel() + 2 * Ss.numel() + 2 * sc.numel() + 2 * ts.numel()
    byte_s = elems * esize / HBM_BYTES_PER_S
    cands = Cc.numel() + Ss.numel()
    layers = int(layers_run(args, mode).sum())
    ops = ts.numel() * cands + 2 * cands * layers
    op_s = ops / PEAK_OPS[dtype]
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations")


def check_kernel(label, cpu_args, minplus):
    """Hold K1 against sweep_plain on the card, both modes, both dtypes.
    Returns the float64 sum-mode measurements at these inputs."""
    out = {}
    for mode in ("sum", "max"):
        f64 = [a.cuda() if torch.is_tensor(a) else a for a in cpu_args]
        got = minplus.sweep_minplus(*f64, mode=mode)
        want = minplus.sweep_plain(*f64, mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K1 f64 {label}/{mode}: {bad} of "
                                 f"{got.numel()} values differ from plain")
        want_cpu = minplus.sweep_plain(*cpu_args, mode=mode)
        if not torch.equal(got.cpu(), want_cpu):
            raise AssertionError(f"K1 f64 {label}/{mode} differs from the "
                                 "plain version on the CPU")
        f32 = [a.float() if torch.is_tensor(a) else a for a in f64]
        got32 = minplus.sweep_minplus(*f32, mode=mode).double()
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got32)):
            raise AssertionError(f"K1 f32 {label}/{mode}: finite masks differ")
        rel = ((got32[fin] - want[fin]).abs()
               / want[fin].abs().clamp_min(1e-300))
        rel_max = float(rel.max()) if rel.numel() else 0.0
        if rel_max > F32_RTOL:
            raise AssertionError(f"K1 f32 {label}/{mode}: rel err {rel_max}")
        ms = cuda_ms(lambda: minplus.sweep_minplus(*f64, mode=mode))
        plain = cuda_ms(lambda: minplus.sweep_plain(*f64, mode=mode))
        bnd, by = bound_ms(f64, mode, torch.float64)
        N, I1 = f64[0].shape[:2]
        log(f"K1 {label} mode={mode} N={N} I+1={I1} K={f64[6]} "
            f"S={f64[7].numel()}: f64 bitwise equal, f32 max rel err "
            f"{rel_max:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bnd:.6f} ms ({by})")
        if mode == "sum":
            out = {"S": f64[7].numel(), "N": N, "I1": I1, "K": f64[6],
                   "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                   "bound_by": by,
                   "max_abs_err": float((got - want).abs().nan_to_num().max())}
    return out


def largest_window(calls):
    """The sum-mode call with the most thresholds (the phase-3 window)."""
    sums = [args for args, mode in calls if mode == "sum"]
    return max(sums, key=lambda a: a[7].numel())


def all_thresholds(planner, b, max_s=1024):
    """K1's inputs over every candidate threshold of the graph at ``b`` —
    the widest window Algorithm 1 could sweep — thinned evenly to at most
    ``max_s`` thresholds."""
    dp = planner._dp(b, planner.default_K(None))
    ts = dp.all_betas()
    ts = ts[::max(1, -(-ts.numel() // max_s))]
    return (*dp._kernel_args(), ts)


def main() -> int:
    # 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs "
            "an NVIDIA GPU")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.core import (breakdown, make_edge_network, no_pipeline,
                                  num_fills, ours, random_profile,
                                  vgg16_profile, Planner)
    from repro_torch.core import shortest_path
    from repro_torch.data import classification_batches
    from repro_torch.kernels import _build
    from repro_torch.kernels import minplus
    from repro_torch.kernels.minplus import kernel as minplus_kernel
    from repro_torch.models import vgg
    from repro_torch.pipeline import (SplitLearningExecutor,
                                      simulate_from_breakdown)

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    minplus_kernel._library()
    log(f"build: K1 in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log(minplus_kernel.LIB_NAME).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    # 3. kernel ----------------------------------------------------------
    profile = vgg16_profile(work_units="bytes")
    net = make_edge_network(num_servers=6, num_clients=4, seed=1,
                            kappa=1 / 32.0)
    t0 = time.perf_counter()
    with recording_sweeps(shortest_path) as calls:
        plan_cpu = ours(profile, net, B=512, b0=20, device="cpu")
    cpu_plan_s = time.perf_counter() - t0
    quick = check_kernel("quickstart window", largest_window(calls), minplus)
    quick_all = check_kernel(
        "quickstart all-thresholds",
        all_thresholds(Planner(profile, net, device="cpu"), plan_cpu.b),
        minplus)

    fleet_prof = random_profile(np.random.default_rng(1), 30)
    fleet_net = make_edge_network(num_servers=48, num_clients=4, seed=1,
                                  kappa=1 / 32.0,
                                  mem_range=(4 * 2**30, 32 * 2**30))
    fleet_planner = Planner(fleet_prof, fleet_net, device="cpu")
    with recording_sweeps(shortest_path) as fcalls:
        fleet_cpu = fleet_planner.solve(16, 128)
    fleet = check_kernel("fleet window", largest_window(fcalls), minplus)
    fleet_all = check_kernel("fleet all-thresholds",
                             all_thresholds(fleet_planner, 16), minplus)
    fleet_gpu = Planner(fleet_prof, fleet_net, device="cuda").solve(16, 128)
    assert (fleet_gpu.solution.cuts, fleet_gpu.solution.placement,
            fleet_gpu.objective) == (fleet_cpu.solution.cuts,
                                     fleet_cpu.solution.placement,
                                     fleet_cpu.objective), "fleet solve"
    log(f"fleet solve (b=16, B=128) equal on cuda and cpu: "
        f"cuts={fleet_gpu.solution.cuts} obj={fleet_gpu.objective!r}")

    # 4. plan (the main path) ---------------------------------------------
    minplus.sweep_minplus.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = ours(profile, net, B=512, b0=20, device="cuda")
    torch.cuda.synchronize()
    gpu_plan_s = time.perf_counter() - t0
    launches = minplus.sweep_minplus.launches
    keys = ("b", "T_f", "T_i", "L_t", "objective")
    got = (plan.solution.cuts, plan.solution.placement,
           *(getattr(plan, k) for k in keys))
    want = (plan_cpu.solution.cuts, plan_cpu.solution.placement,
            *(getattr(plan_cpu, k) for k in keys))
    if got != want:
        raise AssertionError(f"ours on cuda {got} != cpu {want}")
    if launches <= 0:
        raise AssertionError("ours on cuda did not launch K1")
    log(f"plan: cuts={plan.solution.cuts} placement={plan.solution.placement}"
        f" b={plan.b} T_f={float(plan.T_f)!r} T_i={float(plan.T_i)!r} "
        f"L_t={float(plan.L_t)!r} "
        f"(bit-equal to the CPU run); K1 launches={launches}; planner wall "
        f"{gpu_plan_s:.3f} s on cuda, {cpu_plan_s:.3f} s on cpu")
    np_plan = no_pipeline(profile, net, B=512, device="cuda")
    np_cpu = no_pipeline(profile, net, B=512, device="cpu")
    assert (np_plan.solution.cuts, np_plan.L_t) == (np_cpu.solution.cuts,
                                                    np_cpu.L_t), "no_pipeline"
    log(f"no-pipeline L_t={float(np_plan.L_t)!r} -> pipelining speedup "
        f"{np_plan.L_t / plan.L_t:.2f}x")
    sim = simulate_from_breakdown(breakdown(profile, net, plan.solution,
                                            plan.b),
                                  num_fills(512, plan.b) + 1)
    if not (math.isfinite(sim.makespan) and abs(sim.rel_gap) < 1e-9):
        raise AssertionError(f"Eq. (14) check: gap {sim.rel_gap}")
    log(f"event-sim makespan {float(sim.makespan)!r} vs analytic "
        f"{float(sim.analytic)!r} "
        f"(gap {sim.rel_gap:.2e})")

    # 5. train -------------------------------------------------------------
    # the comparison runs in full float32: cuDNN convolutions default to
    # TF32 on the card, so TF32 is switched off for this phase
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = ours(profile, net, B=16, b0=4, device="cuda")
    params = vgg.init_params(torch.Generator().manual_seed(0))
    batches = classification_batches(batch=16, seed=0)
    rounds = [next(batches) for _ in range(2)]
    ex_gpu = SplitLearningExecutor(small, profile, net, params=params,
                                   device="cuda")
    ex_cpu = SplitLearningExecutor(small, profile, net, params=params,
                                   device="cpu")
    for r, batch in enumerate(rounds):
        lg = ex_gpu.train_round(batch, lr=0.05, momentum=0.9)
        lc = ex_cpu.train_round(batch, lr=0.05, momentum=0.9)
        if not (math.isfinite(lg) and abs(lg - lc) <= LOSS_RTOL * abs(lc)):
            raise AssertionError(f"round {r}: loss cuda {lg} vs cpu {lc}")
        log(f"train round {r} (B=16, q={small.num_microbatches}, TF32 off): "
            f"loss cuda {lg!r} cpu {lc!r} (rel {abs(lg - lc) / abs(lc):.2e}, "
            f"tolerance {LOSS_RTOL})")
    pdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(ex_gpu.full_params.parameters(),
                                ex_cpu.full_params.parameters()))
    log(f"parameters after 2 rounds: max abs diff cuda vs cpu {pdiff:.3e}")

    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults again
    ex = SplitLearningExecutor(plan, profile, net, seed=0, device="cuda")
    big = classification_batches(batch=512, seed=1)
    ex.train_round(next(big), lr=0.01, momentum=0.9)         # warm-up
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(3):
        batch = next(big)
        t0 = time.perf_counter()
        losses.append(ex.train_round(batch, lr=0.01, momentum=0.9))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"B=512 losses {losses}")
    log(f"train B=512 plan (b={plan.b}, q={plan.num_microbatches}, cuDNN "
        f"TF32 default): ms/round {[round(t, 3) for t in times]}, losses "
        f"{[round(v, 4) for v in losses]}")

    log(json.dumps({"kernels": [{
        "name": "minplus_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:43",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"]
                           for r in (quick, quick_all, fleet, fleet_all)),
        "ms": quick["ms"], "plain_ms": quick["plain_ms"],
        "bound_ms": quick["bound_ms"], "bound_by": quick["bound_by"],
        "library_ms": None,
        "quickstart_all_thresholds": quick_all,
        "fleet_window": fleet, "fleet_all_thresholds": fleet_all,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
