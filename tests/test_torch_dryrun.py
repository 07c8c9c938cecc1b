"""The port's dry run (``repro_torch/launch/dryrun.py``), the counterpart of
``tests/test_spmd.py::
test_small_mesh_train_step_lowers_with_production_rules``.

The cell: qwen3-0.6b reduced (2 layers, d 64, 4 / 2 heads of 16, d_ff
128, vocab 256, tied), a batch of 8 x 32 in Q = 2 micro-batches, AdamW, on
a (data 2 x model 4) mesh under ``ShardingPolicy()``.  The port traces rank
0's step on fake CPU tensors over a fake process group of 8; the reference
lowers the same step in a subprocess with 8 host devices and reads XLA's
``memory_analysis`` and ``hlo_cost``.  Held equal (``==``): the argument
bytes per device, and the FLOPs per device at remat "none" and "layer"
(torch's checkpoint recomputes each layer's forward up to its last saved
input, so not the last product, ``w_down``, as XLA does not: the "layer"
count is the "none" count plus each layer's forward less ``w_down``,
counted here from the shapes).  The temp bytes are positive.

Then one reduced cell of the MoE, SSM and VLM families on a (data 2 x
model 2) fake mesh (the hybrid and audio families' training cells are in
``test_torch_dryrun_hybrid.py`` / ``test_torch_dryrun_audio.py``), and a
``--mode pipeline`` cell on (stage 2 x model 2): every record key present
and every number finite.
On a CPU-only build of torch a fake CUDA cell raises (no CUDA device guard
for autograd, no device handle for a CUDA mesh); with a CUDA build its
argument bytes equal the CPU cell's.
"""

import dataclasses
import json
import math
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
ARCH, BATCH, SEQ, Q = "qwen3-0.6b", 8, 32, 2

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "src")
    import dataclasses, jax, jax.numpy as jnp
    from repro.configs import get_config, param_specs
    from repro.launch import (ShardingPolicy, batch_sharding,
                              opt_sharding_tree, param_sharding_tree,
                              make_train_step)
    from repro.launch.compat import AxisType, make_mesh, set_mesh
    from repro.optim import get_optimizer
    from repro.utils import hlo_cost
    mesh = make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
    out = {}
    for remat in ("none", "layer"):
        cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                                  remat=remat)
        policy = ShardingPolicy()
        pshapes = param_specs(cfg)
        psh = param_sharding_tree(cfg, mesh, pshapes, policy)
        opt = get_optimizer("adamw")
        oshapes = jax.eval_shape(opt.init, pshapes)
        osh = opt_sharding_tree(mesh, "adamw", psh, pshapes)
        bshapes = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32),
                   "labels": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
        bsh = batch_sharding(cfg, mesh, bshapes, policy)
        step = make_train_step(cfg, opt, 2)
        jitted = jax.jit(step, in_shardings=(psh, osh, bsh),
                         out_shardings=(psh, osh, None))
        with set_mesh(mesh):
            compiled = jitted.lower(pshapes, oshapes, bshapes).compile()
        mem = compiled.memory_analysis()
        out[remat] = {"args": mem.argument_size_in_bytes,
                      "temp": mem.temp_size_in_bytes,
                      "flops": hlo_cost(compiled.as_text()).flops}
    print(json.dumps(out))
""")

#: the reference's record keys (``repro/launch/dryrun.py:127-151``) as the
#: port keeps them
KEYS = {"arch", "shape", "mesh", "kind", "lower_compile_seconds", "devices",
        "memory", "xla_flops_per_device", "xla_bytes_per_device",
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collective_breakdown",
        "while_trip_counts", "unresolved_loops", "op_histogram",
        "hbm_per_device", "fits_80gb"}
MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
          "temp_size_in_bytes", "alias_size_in_bytes",
          "generated_code_size_in_bytes"}
#: one reduced cell a family (the MoE, SSM and VLM ones; the dense
#: family's is the small-mesh cell above)
FAMILY_CELLS = [("granite-moe-3b-a800m", "prefill_32k"),
                ("rwkv6-1.6b", "prefill_32k"),
                ("internvl2-1b", "prefill_32k")]


@pytest.fixture(scope="module")
def reference():
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()


def _ref(proc) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trace(arch, shape, sizes, axes=("data", "model"), device="cpu",
          pipeline=False, **over):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    layout = MeshLayout(axes, sizes)
    with dryrun.fake_process_group(layout.size):
        if pipeline:
            return dryrun._lower_pipeline_cell(
                arch, layout, num_stages=layout.shape["stage"], q=Q,
                device=device, cfg=cfg, batch_override=(BATCH, SEQ))
        return dryrun._lower_cell(arch, shape, layout, q_override=Q,
                                  device=device, cfg=cfg,
                                  batch_override=(BATCH, SEQ))


@pytest.fixture(scope="module")
def small(reference):
    port = {remat: trace(ARCH, "train_4k", (2, 4), remat=remat)
            for remat in ("none", "layer")}
    return port, _ref(reference)


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    if isinstance(x, (int, float)):
        return math.isfinite(x)
    return True


def _check_record(rec):
    assert KEYS <= set(rec), KEYS - set(rec)
    assert MEMORY == set(rec["memory"])
    assert _finite(rec)
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["flops_per_device"] > 0


def test_small_mesh_argument_bytes_equal_the_references(small):
    port, ref = small
    for remat in ("none", "layer"):
        mem = port[remat]["memory"]
        assert mem["argument_size_in_bytes"] == ref[remat]["args"]
        assert mem["temp_size_in_bytes"] > 0
        _check_record(port[remat])


def test_small_mesh_flops_per_device_equal_the_references(small):
    port, ref = small
    assert port["none"]["flops_per_device"] == ref["none"]["flops"]
    print(f"remat none: port {port['none']['flops_per_device']}, reference "
          f"{ref['none']['flops']}")


def test_remat_layer_recomputes_each_layers_forward_but_its_last_product(
        small):
    from repro_torch.configs import get_config
    port, ref = small
    cfg = get_config(ARCH, reduced=True)
    d, hd, H, KV, ff = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv,
                        cfg.d_ff)
    tokens = BATCH * SEQ
    # one layer's forward over the whole batch, less w_down: the four
    # projections, the plain attention's two products over all S x S
    # pairs, and the gate / up products; over the 8 devices
    fwd = (2 * tokens * d * (H + 2 * KV) * hd + 2 * tokens * H * hd * d
           + 2 * 2 * BATCH * H * SEQ * SEQ * hd + 2 * 2 * tokens * d * ff)
    want = port["none"]["flops_per_device"] + cfg.num_layers * fwd / 8
    print(f"remat layer: port {port['layer']['flops_per_device']}, "
          f"none + layers' forward {want}, reference {ref['layer']['flops']}")
    assert port["layer"]["flops_per_device"] == want
    assert port["layer"]["flops_per_device"] == ref["layer"]["flops"]


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS,
                         ids=[a for a, _ in FAMILY_CELLS])
def test_a_reduced_cell_of_each_family_traces(arch, shape):
    rec = trace(arch, shape, (2, 2))
    _check_record(rec)
    assert rec["devices"] == 4 and rec["mesh"] == "2x2"


def test_a_pipeline_cell_traces_over_stage_and_model():
    rec = trace(ARCH, "train_4k", (2, 2), axes=("stage", "model"),
                pipeline=True, num_layers=4)
    _check_record(rec)
    assert rec["kind"] == "train-pipeline"
    assert rec["rank"] == {"data": 0, "stage": 0, "model": 0}
    # the stage hops and the model group's sums moved bytes
    assert rec["collective_breakdown"]["collective-permute"] > 0
    assert rec["collective_breakdown"]["all-reduce"] > 0


def test_fake_cuda_cells_need_a_cuda_build():
    cpu = trace(ARCH, "prefill_32k", (2, 2))
    if not torch.backends.cuda.is_built():
        with pytest.raises(RuntimeError, match="CUDA build of torch"):
            trace(ARCH, "prefill_32k", (2, 2), device="cuda")
        return
    cuda = trace(ARCH, "prefill_32k", (2, 2), device="cuda")
    assert cuda["memory"]["argument_size_in_bytes"] == \
        cpu["memory"]["argument_size_in_bytes"]
    assert cuda["kernels"]["flash_attention"]["calls"] > 0
