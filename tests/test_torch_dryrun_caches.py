"""The dry run's serving cells whose caches are recurrent states or carry
more than a KV cache (``repro_torch/launch/dryrun.py``), against the
reference on a (data 2 x model 2) mesh.

- rwkv6-1.6b reduced, ``decode_32k`` at a batch of 8 and ``long_500k`` at
  its own batch of 1 and 524,288 positions: the cache is RWKV6's state,
  whose WKV leaf (L, B, H, hd, hd) has no length axis (the dry run used to
  write the cell's length over its heads); at the batch of 8 the FLOPs
  and argument bytes per device equal the reference's (``==``).
- whisper-small (one encoder and one decoder layer) and jamba-1.5-large
  (one period of a Mamba and an attention slot) reduced, ``prefill_32k``
  at 8 x 32: the prefill builds its caches, cross keys and values and
  Mamba states on the keys' mesh (they were plain tensors, which a
  DTensor cannot be written into).

Each cache leaf the step returns has the shape the reference's
``cache_specs`` gives (``tests/dryrun_reference.py``), laid out by the
cache rules (the reference's ``out_shardings``), its batch over "data"
where it divides.
"""

import pytest
import torch

from test_torch_dryrun import _check_record
from test_torch_dryrun_multipod import port_cell, records, reference_cells

MESH = {"axes": ["data", "model"], "sizes": [2, 2]}
CELLS = [
    {"arch": "rwkv6-1.6b", "shape": "decode_32k", "batch": [8, 32]},
    {"arch": "rwkv6-1.6b", "shape": "long_500k", "batch": [1, 524288]},
    {"arch": "whisper-small", "shape": "prefill_32k", "batch": [8, 32],
     "over": {"num_layers": 1, "encoder_layers": 1}},
    {"arch": "jamba-1.5-large-398b", "shape": "prefill_32k",
     "batch": [8, 32], "over": {"num_layers": 2, "attn_every": 2}},
]
for _c in CELLS:
    _c.update(MESH)
IDS = [f"{c['arch']}-{c['shape']}" for c in CELLS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cells():
    proc = reference_cells(CELLS)
    try:
        port = [port_cell(c) for c in CELLS]
        return dict(zip(IDS, zip(port, records(proc))))
    finally:
        if proc.poll() is None:
            proc.kill()


def _leaves(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}{k}/"))
        else:
            out[path + k] = v
    return out


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_the_cell_traces_with_the_references_cache_shapes(cells, i):
    port, ref = cells[IDS[i]]
    _check_record(port)
    want = _leaves(ref["cache_shapes"])
    assert {k: v["shape"] for k, v in port["cache"].items()} == want


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_each_cache_leaf_is_laid_out_by_the_cache_rules(cells, i):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import MeshLayout
    c = CELLS[i]
    port, _ = cells[IDS[i]]
    layout = MeshLayout(tuple(c["axes"]), tuple(c["sizes"]))
    cfg = dataclasses.replace(get_config(c["arch"], reduced=True),
                              **c.get("over", {}))
    for name, leaf in port["cache"].items():
        spec = shlib.cache_sharding(cfg, layout, torch.empty(
            leaf["shape"], device="meta")).spec
        assert leaf["placements"] == [
            str(p) for p in shlib.placements(spec, layout)], name
        # the batch over "data" wherever it divides
        if leaf["shape"][1] % 2 == 0:
            assert spec[1] == "data", name


def test_recurrent_decode_counts_the_references_flops_and_arguments(cells):
    port, ref = cells[IDS[0]]
    assert port["flops_per_device"] == ref["flops_per_device"]
    assert port["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
