"""The MoE FFN's mesh path (``repro_torch/models/moe.py::moe_ffn`` on
DTensors, the dry run's sharded layers) on real values, in four spawned
gloo ranks on the CPU (``tests/torch_moe_mesh_worker.py``) over a (data 2
x model 2) mesh, against the plain ``moe_ffn`` on the same weights.

Each config is reduced, in float32, its parameters placed by the sharding
rules (``launch/sharding.py``); the output and the gradients of <y, gy>
for the input, the router and the three expert matrices, gathered whole,
within 1e-5 of each tensor's largest magnitude of the plain call's:

- ``qwen3``: qwen3-moe-235b-a22b (8 experts, 4 a model rank, FSDP blocks
  over "data"), a 1-row micro-batch under ``batch_layout``: the rows
  replicated over "data", so the experts keep their blocks and each
  product runs on its slice (``_moe_stationary``): a rank's FLOPs are a
  quarter of the plain call's, backward included;
- ``jamba``: jamba-1.5-large-398b (4 experts, 4 slices of d_ff), the same
  layout with the slices taken from each data rank's block of d_ff;
- ``granite``: granite-moe-3b-a800m (5 experts over 2 model ranks: each
  expert's d_ff split, no FSDP), 1 row: every rank runs its columns whole
  over "data", as the reference's lowering does;
- ``qwen3_rows``: qwen3-moe-235b-a22b with 2 rows split over "data": the
  weights gathered, each data rank its row, the weights' gradients summed
  over the data ranks.

The plain ``moe_ffn`` is held to the reference by ``tests/test_torch_moe*.py``.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
CASES = [
    {"tag": "qwen3", "arch": "qwen3-moe-235b-a22b", "rows": 1, "seq": 32,
     "seed": 0},
    {"tag": "jamba", "arch": "jamba-1.5-large-398b", "rows": 1, "seq": 32,
     "seed": 2},
    {"tag": "granite", "arch": "granite-moe-3b-a800m", "rows": 1, "seq": 32,
     "seed": 1},
    {"tag": "qwen3_rows", "arch": "qwen3-moe-235b-a22b", "rows": 2,
     "seq": 32, "seed": 3},
]
TAGS = [c["tag"] for c in CASES]
#: the cases whose experts keep their FSDP blocks over "data"
STATIONARY = ("qwen3", "jamba")
NAMES = ("y", "x", "router", "w_gate", "w_up", "w_down")
TOL = 1e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_mesh")
    (d / "job.json").write_text(json.dumps(CASES))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    # each rank's output to a file: a rank blocked on a full pipe would
    # stall the others in their next collective
    logs = [open(d / f"rank_{r}.log", "w") for r in range(WORLD)]
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_moe_mesh_worker.py"),
         str(r), str(WORLD), str(d)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    errors = []
    for r, p in enumerate(ranks):
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            for q in ranks:
                q.kill()
            raise
        finally:
            logs[r].close()
        if p.returncode:
            errors.append(f"rank {r}: "
                          f"{(d / f'rank_{r}.log').read_text()[-3000:]}")
    assert not errors, errors
    with np.load(d / "out.npz") as npz:
        return {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("tag", TAGS)
def test_the_mesh_path_equals_the_plain_moe(run, tag, name):
    want, got = run[f"{tag}/plain/{name}"], run[f"{tag}/mesh/{name}"]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max() / scale
    print(f"{tag} {name}: {err:.3e} of scale")
    assert err <= TOL


@pytest.mark.parametrize("tag", TAGS)
def test_the_experts_keep_their_blocks_where_the_rows_are_replicated(run,
                                                                     tag):
    plain, mesh = run[f"{tag}/flops"]
    place = str(run[f"{tag}/placements"])
    if tag in STATIONARY:
        # FSDP blocks over "data", experts over "model": every product
        # (the router's too) on a quarter of the work
        assert "'w_gate': (Shard(dim=1), Shard(dim=0))" in place
        assert mesh == plain / 4
    elif tag == "granite":
        # no FSDP block: the expert products whole over "data", their
        # columns split over "model"; the router whole
        assert "'w_gate': (Replicate(), Shard(dim=2))" in place
        assert plain / 2 < mesh < plain * 0.51
    else:
        # rows split over "data": each data rank its row
        assert "'x': (Shard(dim=0), Replicate())" in place
        assert plain / 4 <= mesh < plain * 0.26
