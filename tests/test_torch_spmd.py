"""The port's SPMD stage pipeline (``repro_torch/pipeline/spmd.py``), its
sharded checkpoints and DTensor's splits, in four spawned gloo ranks on the
CPU (``tests/torch_spmd_worker.py``), against the reference.

The ranks meet through a ``FileStore`` under ``tmp_path`` (no TCP port),
run one intra-op thread each and import no JAX.  One spawn serves every
case: llama3-8b reduced to 4 layers in float32, a batch of 8 x 16 in Q = 4
micro-batches, pipelined over (data 2 x stage 2) and (stage 4), and in
Q = 2 over (stage 4), where two stage ranks score no micro-batch, and in
Q = 8 over (data 2 x stage 2), a micro-batch's one row over two data
ranks (the second holds a padding row); qwen3-0.6b reduced (tied, vocab
256) at 2 layers over (data 2 x stage 1 x model 2) in Q = 2: the
vocabulary split over "model" beside FSDP blocks over "data".  A rank
holds each leaf in the reference's blocks: its stage's layers, each cut
to its FSDP block over the data ranks (the d_model rows or columns of a
projection; of the experts' matrices the first of the two, where it
divides) and to its block on "model"; the embedding's rows and an untied
head's columns to their vocabulary block where the vocabulary divides
the model axis, the head's rows to their FSDP block.  The loss within
1e-5 and every gradient within 1e-4 (absolute) of the reference's plain
``api.loss`` / ``jax.grad`` on the same numpy weights, each rank's
gradient against its block of the reference's (cut here by Megatron's
layout and the FSDP rule above, independently of ``launch/sharding.py``)
— the bounds the reference's own pipeline test keeps
(``tests/test_spmd.py``); one AdamW train step over (data 2 x stage 2):
its loss the reference's, and its update on each block the reference's
AdamW on the block gradients the pipeline gave (held to ``jax.grad``
above); reshard-on-restore from a (4,) "model" mesh to a (2, 2) ("data",
"model") one, as ``tests/test_spmd.py::
test_checkpoint_reshards_across_meshes``, and the stepped (data 2 x stage
2) blocks and AdamW state saved, restored onto (stage 2 x model 2), where
D = 1, and back; and each rank's block under DTensor's placements of a
spec against the block JAX's ``NamedSharding`` gives the same device (a
JAX subprocess with four host devices).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import get_model as ref_model
from repro.optim import get_optimizer as ref_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
ARCH, LAYERS, BATCH, SEQ, Q = "llama3-8b", 4, 8, 16, 4
#: the tied config with the vocabulary split beside a data axis
TIED = "qwen3-0.6b"
#: the configs the spawn runs, and their depth
MODELS = {ARCH: LAYERS, TIED: 2}
LR = 1e-3
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4
#: the train step against the reference's AdamW on the same gradients:
#: float32 rounding of the two formulas, relative to each tensor's largest
#: magnitude.  (Against AdamW on jax.grad's gradients no such bound holds:
#: the first step is g / (|g| + 1e-8), so where |g| is near 1e-8 a
#: gradient difference of 1e-10 moves the step by a few % of the rate.)
STEP_REL = 1e-6
PIPELINES = [
    {"tag": "d2s2", "axes": ["data", "stage"], "sizes": [2, 2], "stages": 2,
     "q": Q},
    {"tag": "s4", "axes": ["stage"], "sizes": [4], "stages": 4, "q": Q},
    # fewer micro-batches than stages: ranks 2 and 3 run no head
    {"tag": "s4q2", "axes": ["stage"], "sizes": [4], "stages": 4, "q": 2},
    # fewer rows a micro-batch than data ranks: one row over two, data
    # rank 1 holding a padding row
    {"tag": "d2s2q8", "axes": ["data", "stage"], "sizes": [2, 2],
     "stages": 2, "q": 8},
    # the tied embedding's rows over "model" (a masked lookup, the
    # vocabulary-parallel head) beside the layers' FSDP blocks
    {"tag": "d2m2_tied", "arch": TIED, "axes": ["data", "stage", "model"],
     "sizes": [2, 1, 2], "stages": 1, "q": 2},
]
for _c in PIPELINES:
    _c.setdefault("arch", ARCH)
#: each train case holds its step to the gradients of the pipeline case
#: ``grads`` (the same mesh, config and Q); ``reshard``: the layout its
#: stepped blocks and AdamW state are restored onto, and back
TRAIN = [{"tag": "train", "arch": ARCH, "axes": ["data", "stage"],
          "sizes": [2, 2], "stages": 2, "q": Q, "grads": "d2s2",
          "reshard": {"axes": ["stage", "model"], "sizes": [2, 2],
                      "stages": 2}}]
#: (mesh axes, sizes, spec, tensor shape): a dim over two axes, major to
#: minor, as the reference shards d_model over ("pod", "data")
SPLITS = [
    (["pod", "data"], [2, 2], [["pod", "data"], None], [8, 4]),
    (["data", "model"], [2, 2], [None, "model"], [8, 4]),
    (["data", "model"], [2, 2], ["data", "model"], [4, 8]),
    (["data", "model"], [2, 2], [["data", "model"], None], [8, 2]),
    (["pod", "data", "model"], [2, 1, 2], [["pod", "data"], "model"],
     [4, 6]),
]

JAX_SPLITS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np, jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    out = []
    for names, sizes, spec, shape in json.loads(sys.argv[1]):
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes), tuple(names))
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
        out.append({d.id: [[s.start or 0, shape[i] if s.stop is None
                            else s.stop] for i, s in enumerate(sl)]
                    for d, sl in idx.items()})
    print(json.dumps(out))
""")


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _reference(name, spec, d):
    """The reference model ``name`` (an arch at ``spec`` layers, or
    ``spec`` = {"arch", "layers", "over": config fields, "seq": the
    batch's length}; float32, remat none), its weights and a batch,
    written for the ranks; returns (api, params, batch)."""
    if not isinstance(spec, dict):
        spec = {"arch": name, "layers": spec}
    cfg = dataclasses.replace(ref_config(spec["arch"], reduced=True),
                              num_layers=spec["layers"], remat="none",
                              compute_dtype=jnp.float32,
                              **spec.get("over", {}))
    api = ref_model(cfg)
    params = api.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    shape = (BATCH, spec.get("seq", SEQ))
    batch = {"tokens": rng.integers(0, cfg.vocab, shape, np.int32),
             "labels": rng.integers(0, cfg.vocab, shape, np.int32)}
    np.savez(d / f"weights_{name}.npz", **_flat(params),
             **{f"batch/{k}": v for k, v in batch.items()})
    return api, params, batch


def spawn(d, models, pipelines, train, splits):
    """Run the ranks on ``models`` ({name: layers, or a spec, see
    :func:`_reference`}) and the cases; returns {"ref": each model's
    reference loss, gradients, weights and experts, "outs": each rank's
    arrays, "jax_splits": JAX's blocks of ``splits``}."""
    refs = {name: _reference(name, models[name], d) for name in models}
    (d / "job.json").write_text(json.dumps(
        {"models": models, "pipelines": pipelines, "train": train,
         "lr": LR, "splits": splits}))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    # each rank's output to a file: a rank blocked on a full pipe would
    # stall the others in their next collective
    logs = [open(d / f"rank_{r}.log", "w") for r in range(WORLD)]
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_spmd_worker.py"),
         str(r), str(WORLD), str(d)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SPLITS,
                                 json.dumps(splits)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    ref = {}
    for arch, (api, params, batch) in refs.items():
        loss, grads = jax.jit(jax.value_and_grad(api.loss))(params, batch)
        ref[arch] = {"loss": float(loss), "grads": _flat(grads),
                     "weights": _flat(params),
                     "experts": api.cfg.moe_experts}
    errors = []
    out, err = jax_proc.communicate(timeout=120)
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
    assert jax_proc.returncode == 0, err[-3000:]
    outs = []
    for r in range(WORLD):
        with np.load(d / f"out_{r}.npz") as npz:
            outs.append({k: npz[k] for k in npz.files})
    return {"ref": ref, "outs": outs,
            "jax_splits": json.loads(out.strip().splitlines()[-1])}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd"), MODELS, PIPELINES, TRAIN,
                 SPLITS)


def _stage_rows(full, k, stages):
    n = full.shape[0] // stages
    return full[k * n:(k + 1) * n]


#: Megatron's blocks on a "model" axis: the columns of these (the last dim;
#: a bias as its matrix; the attention's flat columns, whole heads or
#: not), the rows of those; the experts' dim of the MoE matrices when the
#: axis divides E, else their columns / rows.  The router and the norm
#: scales stay whole.
_COLS = ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv", "b_up")
_ROWS = ("wo", "w_down")


def _part(full, dim, i, n):
    w = full.shape[dim] // n
    return np.take(full, np.arange(i * w, (i + 1) * w), axis=dim)


def _model_part(key, full, m, M, experts):
    name = key.split("/")[-1]
    if M == 1:
        return full
    # the vocabulary: the embedding's rows, an untied head's columns
    if key in ("embed", "lm_head"):
        V = full.shape[0 if key == "embed" else 1]
        return _part(full, 0 if key == "embed" else 1, m, M) \
            if V % M == 0 else full
    if not key.startswith("layers/") or name not in _COLS + _ROWS:
        return full
    if key.startswith("layers/moe/") and experts % M == 0:
        dim = 1
    else:
        dim = full.ndim - (2 if name in _ROWS else 1)
    return _part(full, dim, m, M)


#: the FSDP block over D data ranks: a dense projection's d_model dim (the
#: rows of the column blocks, the columns of the row blocks), an untied
#: head's d_model rows; of an expert-parallel matrix (E, a, b) the a dim
#: (expert-sliced TP has none); each only where it divides D.  The
#: embedding, the norms, the biases and the router have none.
def _data_part(key, full, d, D, experts, M):
    name = key.split("/")[-1]
    if D == 1:
        return full
    if key == "lm_head":
        dim = 0
    elif not key.startswith("layers/") or name not in _COLS + _ROWS \
            or name in ("bq", "bk", "bv", "b_up"):
        return full
    elif key.startswith("layers/moe/"):
        if experts % M:
            return full
        dim = full.ndim - 2
    else:
        dim = full.ndim - (1 if name in _ROWS else 2)
    return _part(full, dim, d, D) if full.shape[dim] % D == 0 else full


def _model_size(case):
    return dict(zip(case["axes"], case["sizes"])).get("model", 1)


def _data_size(case):
    return dict(zip(case["axes"], case["sizes"])).get("data", 1)


def _want(key, ref, k, stages, m=0, M=1, experts=0, d=0, D=1):
    full = _data_part(key, _model_part(key, ref[key], m, M, experts), d, D,
                      experts, M)
    return _stage_rows(full, k, stages) if key.startswith("layers/") \
        else full


def check_loss(run, case):
    """Every rank's pipelined loss against the reference's plain one."""
    want = run["ref"][case["arch"]]["loss"]
    for o in run["outs"]:
        assert abs(float(o[f"{case['tag']}/loss"]) - want) < \
            LOSS_ATOL, (float(o[f"{case['tag']}/loss"]), want)
        assert str(o[f"{case['tag']}/transport"]) == "direct"
        # the model group's sums moved bytes exactly where it has ranks
        assert (int(o[f"{case['tag']}/tp_bytes"]) > 0) == \
            (_model_size(case) > 1)


def _coords(o, tag):
    return tuple(int(o[f"{tag}/{a}"]) for a in ("data", "stage", "model"))


def check_grads(run, case):
    """Every rank's gradients against its block of ``jax.grad``'s."""
    tag, S, M, D = case["tag"], case["stages"], _model_size(case), \
        _data_size(case)
    ref = run["ref"][case["arch"]]
    seen = set()
    for o in run["outs"]:
        d, k, m = _coords(o, tag)
        pre = f"{tag}/grad/"
        keys = {key[len(pre):] for key in o if key.startswith(pre)}
        assert keys == set(ref["grads"]), keys ^ set(ref["grads"])
        for key in keys:
            got = o[pre + key]
            want = _want(key, ref["grads"], k, S, m, M, ref["experts"], d,
                         D)
            assert got.shape == want.shape, key
            err = float(np.max(np.abs(got - want)))
            assert err < GRAD_ATOL, (tag, d, k, m, key, err)
        seen.add((d, k, m))
    assert seen == {(d, k, m) for d in range(D) for k in range(S)
                    for m in range(M)}


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_pipelined_loss_matches_the_references_plain_loss(run, case):
    check_loss(run, case)


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_pipelined_gradients_match_jax_grad(run, case):
    check_grads(run, case)


def _nest(flat):
    tree = {}
    for key, a in flat.items():
        *path, name = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(a)
    return tree


def check_train(run, case):
    """Every rank's AdamW step against the reference's AdamW on the
    gradients the pipeline gave."""
    tag, S, M, D, via = case["tag"], case["stages"], _model_size(case), \
        _data_size(case), case["grads"]
    ref = run["ref"][case["arch"]]
    opt = ref_optimizer("adamw", lr=LR)
    update = jax.jit(lambda p, g: opt.update(p, g, opt.init(p))[0])
    for o in run["outs"]:
        d, k, m = _coords(o, via)
        assert abs(float(o[f"{tag}/loss"]) - ref["loss"]) < LOSS_ATOL
        pre = f"{tag}/param/"
        keys = {key[len(pre):] for key in o if key.startswith(pre)}
        assert keys == set(ref["weights"])
        local = {key: _want(key, ref["weights"], k, S, m, M, ref["experts"],
                            d, D)
                 for key in keys}
        grads = {key: o[f"{via}/grad/{key}"] for key in keys}
        stepped = _flat(update(_nest(local), _nest(grads)))
        moved = 0
        for key in keys:
            got, want, before = o[pre + key], stepped[key], local[key]
            scale = float(np.max(np.abs(want)))
            assert float(np.max(np.abs(got - want))) <= STEP_REL * scale, key
            moved += int(np.any(got != before))
        assert moved == len(keys)


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: c["tag"])
def test_pipelined_train_step_matches_the_references_adamw(run, case):
    check_train(run, case)


def _whole(run, tag, prefix, case):
    """{key: the whole tensor} put back together from every rank's blocks
    ``{tag}/{prefix}{key}`` of the train case ``case`` (no model axis):
    the data blocks joined along their dim, the stages along dim 0."""
    S, D = case["stages"], _data_size(case)
    ref = run["ref"][case["arch"]]
    pre = f"{tag}/{prefix}"
    out = {}
    for key, full in ref["weights"].items():
        parts = {}
        for o in run["outs"]:
            d, k, _ = _coords(o, case["grads"])
            parts[(d, k)] = o[pre + key]
        # the dim the rule cuts: where a data block differs from the whole
        dims = [i for i in range(full.ndim)
                if _data_part(key, full, 0, D, ref["experts"], 1).shape[i]
                != full.shape[i]]
        rows = [np.concatenate([parts[(d, k)] for d in range(D)], dims[0])
                if dims else parts[(0, k)] for k in range(S)]
        out[key] = np.concatenate(rows, 0) if key.startswith("layers/") \
            else rows[0]
        assert out[key].shape == full.shape, key
    return out


def test_checkpoint_reshards_across_meshes(run):
    # the stepped (data 2 x stage 2) blocks and AdamW state, restored onto
    # (stage 2 x model 2) and back
    case = TRAIN[0]
    there = case["reshard"]
    ref = run["ref"][case["arch"]]
    S, M = there["stages"], dict(zip(there["axes"], there["sizes"]))["model"]
    wholes = {"params/": _whole(run, "train", "param/", case)}
    for moment in ("m", "v"):
        wholes[f"opt/{moment}/"] = _whole(run, "train", f"opt/{moment}/",
                                          case)
    for r, o in enumerate(run["outs"]):
        k, m = r // M, r % M          # the (stage, model) mesh's rank
        for pre, whole in wholes.items():
            for key in whole:
                want = _want(key, whole, k, S, m, M, ref["experts"])
                np.testing.assert_array_equal(o[f"ckpt/there/{pre}{key}"],
                                              want)
                src = f"train/param/{key}" if pre == "params/" else \
                    f"train/{pre}{key}"
                np.testing.assert_array_equal(o[f"ckpt/back/{pre}{key}"],
                                              o[src])
        assert int(o["ckpt/there/opt/t"]) == int(o["ckpt/back/opt/t"]) \
            == int(o["train/opt/t"]) == 1
    x = np.arange(32.0).reshape(8, 4)
    for r, o in enumerate(run["outs"]):
        # saved from a (4,) "model" mesh: rows split four ways
        np.testing.assert_array_equal(o["reshard/saved_local"],
                                      x[2 * r:2 * r + 2])
        # restored onto (data 2, model 2) as (None, "model"): rank (d, m)
        # holds columns [2 m, 2 m + 2), whatever its data index
        m = r % 2
        np.testing.assert_array_equal(o["reshard/local"], x[:, 2 * m:2 * m + 2])
        np.testing.assert_array_equal(o["reshard/full"], x)
        assert str(o["reshard/placements"]) == \
            "(Replicate(), Shard(dim=1))"
        assert int(o["reshard/step"]) == 0


def test_a_mesh_of_another_size_than_the_world_raises(run):
    for o in run["outs"]:
        assert "needs 3 ranks; the process group has 4" in \
            str(o["mesh_size_error"])


def test_a_model_axis_and_other_families_raise():
    """A "model" axis must split every layer into equal blocks: the
    attention's flat query and kv columns (heads that do not split run
    in the reference's layouts, ``transformer.py::attention_mode``) and
    the FFN's columns; the pipeline runs the transformer's layers only.
    Each refuses before any rank is contacted."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models.common import ModelSplit
    from repro_torch.models.transformer import (TransformerLayer,
                                                attention_mode)
    from repro_torch.pipeline.spmd import (PipelineConfig,
                                           check_model_axis,
                                           make_pipelined_loss,
                                           shard_params)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              compute_dtype=torch.float32)
    # 4 query and 2 kv heads of 16: over 4 each rank reads a kv head it
    # shares; over 8 every head is whole and the keys' sequence splits
    check_model_axis(cfg, 4)
    assert attention_mode(cfg, 2) == "heads"
    assert attention_mode(cfg, 4) == "shared_kv"
    assert attention_mode(cfg, 8) == "split_keys"
    layer = TransformerLayer(cfg, device="meta", split=ModelSplit(4))
    assert tuple(layer.wq.shape) == (cfg.d_model, cfg.head_dim)
    assert tuple(layer.wk.shape) == (cfg.d_model, cfg.head_dim // 2)
    assert tuple(layer.wo.shape) == (cfg.head_dim, cfg.d_model)
    assert tuple(layer.w_up.shape) == (cfg.d_model, 44)
    layer = TransformerLayer(cfg, device="meta", split=ModelSplit(8, 7))
    assert tuple(layer.wq.shape) == (cfg.d_model, cfg.head_dim // 2)
    assert tuple(layer.wk.shape) == (cfg.d_model, cfg.head_dim // 4)
    assert tuple(layer.wo.shape) == (cfg.head_dim // 2, cfg.d_model)
    # the flat columns themselves must split, and the FFN's
    with pytest.raises(ValueError, match="64 query columns do not split "
                                         "over a model axis of 3"):
        make_pipelined_loss(cfg, MeshLayout(("stage", "model"), (2, 3)),
                            PipelineConfig(2, 2), "cpu")
    with pytest.raises(ValueError, match="90 FFN columns do not split over "
                                         "a model axis of 4"):
        make_pipelined_loss(dataclasses.replace(cfg, d_ff=90),
                            MeshLayout(("stage", "model"), (2, 4)),
                            PipelineConfig(2, 2), "cpu")
    # and shard_params needs the config to cut by the rules
    with pytest.raises(ValueError, match="needs the config"):
        shard_params({}, MeshLayout(("stage", "model"), (1, 2)),
                     PipelineConfig(1, 2), "cpu")
    with pytest.raises(ValueError, match="has 4 ranks, the pipeline 2"):
        make_pipelined_loss(cfg, MeshLayout(("stage",), (4,)),
                            PipelineConfig(2, 2), "cpu")
    with pytest.raises(ValueError, match="family 'ssm'"):
        make_pipelined_loss(get_config("rwkv6-1.6b", reduced=True),
                            MeshLayout(("stage",), (2,)),
                            PipelineConfig(2, 2), "cpu")


@pytest.mark.parametrize("i", range(len(SPLITS)),
                         ids=lambda i: "-".join(SPLITS[i][0]))
def test_dtensor_splits_as_jax_named_sharding(run, i):
    shape = SPLITS[i][3]
    x = np.arange(int(np.prod(shape))).reshape(shape)
    blocks = run["jax_splits"][i]
    for r, o in enumerate(run["outs"]):
        sl = tuple(slice(a, b) for a, b in blocks[str(r)])
        np.testing.assert_array_equal(o[f"split/{i}"], x[sl])
