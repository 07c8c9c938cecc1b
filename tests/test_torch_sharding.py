"""The port's mesh layouts, sharding rules and meta-device specs
(``repro_torch/launch/{mesh,sharding}.py``, ``configs/base.py``) against
the reference's, on the CPU, for every config.

The reference's rules read only ``mesh.shape`` and ``mesh.axis_names``, so
they run here on the port's ``MeshLayout`` as a stand-in mesh (no
512-device JAX process), with the reference module's ``NamedSharding``
swapped for a plain (mesh, spec) pair.  A spec is compared entry by entry;
a one-axis tuple is written as the axis name on both sides, as
``PartitionSpec`` canonicalizes it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.mesh as ref_mesh
import repro.launch.sharding as ref_sharding
from repro.configs import (cache_specs as ref_cache_specs,
                           get_config as ref_config,
                           input_specs as ref_input_specs,
                           param_specs as ref_param_specs,
                           runnable_cells as ref_runnable_cells,
                           CONFIGS as REF_CONFIGS)

from repro_torch.configs import (ARCH_IDS, CONFIGS, SHAPE_NAMES, cache_specs,
                                 get_config, input_specs, param_specs,
                                 runnable_cells)
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MeshLayout
from repro_torch.optim import get_optimizer

LAYOUTS = {
    "16x16": MeshLayout(("data", "model"), (16, 16)),
    "2x16x16": MeshLayout(("pod", "data", "model"), (2, 16, 16)),
    "16x4x4": MeshLayout(("data", "stage", "model"), (16, 4, 4)),
    "2x4": MeshLayout(("data", "model"), (2, 4)),
}
POLICIES = {
    "default": {},
    "no-fsdp": {"fsdp": False},
    "no-vocab": {"shard_vocab": False},
    "cache-heads": {"cache_seq_on_model": False},
    "data-only": {"batch_axes": ("data",)},
}


@dataclasses.dataclass(frozen=True)
class _RefNamedSharding:
    mesh: object
    spec: tuple


@pytest.fixture(autouse=True)
def _stand_in(monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _RefNamedSharding)


_PARAM_SPECS = {}


def _param_specs(arch):
    if arch not in _PARAM_SPECS:
        _PARAM_SPECS[arch] = (ref_param_specs(ref_config(arch)),
                              param_specs(get_config(arch)))
    return _PARAM_SPECS[arch]


def _canon(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _RefNamedSharding))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _port_flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _same_specs(ref_tree, port_tree):
    want, got = _ref_flat(ref_tree), _port_flat(port_tree)
    assert set(want) == set(got), set(want) ^ set(got)
    for key in want:
        assert _canon(got[key].spec) == _canon(want[key].spec), \
            (key, got[key].spec, want[key].spec)
    return len(want)


def _policies(name):
    kw = POLICIES[name]
    return ref_sharding.ShardingPolicy(**kw), sharding.ShardingPolicy(**kw)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", LAYOUTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh, policy):
    ref_shapes, shapes = _param_specs(arch)
    lay = LAYOUTS[mesh]
    ref_pol, pol = _policies(policy)
    want = ref_sharding.param_sharding_tree(ref_config(arch), lay,
                                            ref_shapes, ref_pol)
    got = sharding.param_sharding_tree(get_config(arch), lay, shapes, pol)
    assert _same_specs(want, got) > 0


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_specs_equal_the_references(arch, opt):
    ref_shapes, shapes = _param_specs(arch)
    lay = LAYOUTS["2x16x16"]
    ref_psh = ref_sharding.param_sharding_tree(ref_config(arch), lay,
                                               ref_shapes)
    psh = sharding.param_sharding_tree(get_config(arch), lay, shapes)
    want = ref_sharding.opt_sharding_tree(lay, opt, ref_psh, ref_shapes)
    got = sharding.opt_sharding_tree(lay, opt, psh, shapes)
    if opt == "sgd":
        assert got == {} == want
        return
    _same_specs(want, got)
    # the port's optimizer state has the tree the specs describe
    state = get_optimizer(opt).init(shapes)
    assert set(_port_flat(state)) == set(_port_flat(got))


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_the_references(arch, mesh):
    lay = LAYOUTS[mesh]
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    for shape in SHAPE_NAMES:
        if (arch, shape) not in runnable_cells({arch: cfg}):
            continue
        ref_in, port_in = ref_input_specs(ref_cfg, shape), \
            input_specs(cfg, shape)
        if "pos" in ref_in:
            # a decode step shards its token; the position is a scalar
            # (the reference's dry run does the same)
            ref_in, port_in = {"t": ref_in["token"]}, {"t": port_in["token"]}
        for name in POLICIES:
            ref_pol, pol = _policies(name)
            _same_specs(
                ref_sharding.batch_sharding(ref_cfg, lay, ref_in, ref_pol),
                sharding.batch_sharding(cfg, lay, port_in, pol))
            _same_specs(
                ref_sharding.cache_sharding(
                    ref_cfg, lay, ref_cache_specs(ref_cfg, shape), ref_pol),
                sharding.cache_sharding(cfg, lay, cache_specs(cfg, shape),
                                        pol))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _same_shapes(ref_tree, port_tree):
    want = {k: v for k, v in _ref_flat(ref_tree).items()}
    got = _port_flat(port_tree)
    assert set(want) == set(got), set(want) ^ set(got)
    for key, w in want.items():
        g = got[key]
        assert g.device.type == "meta", key
        assert tuple(g.shape) == tuple(w.shape), key
        assert _dtype(g) == str(jnp.dtype(w.dtype)), key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_specs_equal_the_references_shapes_and_dtypes(arch):
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    _same_shapes(*_param_specs(arch))
    for shape in SHAPE_NAMES:
        _same_shapes(ref_input_specs(ref_cfg, shape), input_specs(cfg, shape))
        _same_shapes(ref_cache_specs(ref_cfg, shape), cache_specs(cfg, shape))


def test_runnable_cells_equal_the_references():
    assert runnable_cells(CONFIGS) == ref_runnable_cells(REF_CONFIGS)
    assert set(CONFIGS) == set(REF_CONFIGS)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_layouts_equal_the_references(multi_pod):
    prod = port_mesh.production_layout(multi_pod=multi_pod)
    assert prod.sizes == ((2, 16, 16) if multi_pod else (16, 16))
    assert prod.axis_names == (("pod", "data", "model") if multi_pod
                               else ("data", "model"))
    for S in (1, 2, 4, 8, 16):
        pipe = port_mesh.pipeline_layout(multi_pod=multi_pod, num_stages=S)
        assert pipe.size == prod.size
        assert pipe.shape["stage"] * pipe.shape["model"] == 16
    for lay in [prod, *LAYOUTS.values()]:
        assert port_mesh.data_axes(lay) == ref_mesh.data_axes(lay)
        assert port_mesh.mesh_tag(lay) == ref_mesh.mesh_tag(lay)
    with pytest.raises(ValueError):
        port_mesh.pipeline_layout(num_stages=3)


def test_a_mesh_of_the_wrong_size_raises():
    # no process group here: build_mesh refuses before looking at sizes
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.build_mesh(LAYOUTS["2x4"], "cpu")


def test_placements_split_major_to_minor_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    lay = LAYOUTS["2x16x16"]
    assert sharding.placements((("pod", "data"), "model"), lay) == \
        (Shard(0), Shard(0), Shard(1))
    assert sharding.placements((None, "data"), lay) == \
        (Replicate(), Shard(1), Replicate())
    assert sharding.placements((), lay) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"),), lay)
    with pytest.raises(ValueError, match="names axis 'stage'"):
        sharding.placements(("stage",), lay)
    with pytest.raises(ValueError, match="used twice"):
        sharding.placements(("data", "data"), lay)


def test_param_specs_are_meta_and_hold_no_memory():
    tree = param_specs(get_config("jamba-1.5-large-398b"))
    leaves = list(_port_flat(tree).values())
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(int(np.prod(t.shape)) for t in leaves)
    assert n > 300e9          # the published 398B, without a byte held
    assert all(t.dtype == torch.float32 for t in leaves)
