"""The port's roofline (``repro_torch/launch/roofline.py``) against the
reference's (``repro/launch/roofline.py``): ``active_params``,
``model_flops``, ``model_traffic_bytes`` and ``roofline_row`` equal
(``==``) for every arch x shape on the same record, given the reference's
TPU constants (and its 16 GiB fit); ``load_records`` and ``markdown_table``
give the reference's output from the same files.  The records are drawn
from one numpy seed in the dry run's layout."""

import json
import zlib

import numpy as np
import pytest

from repro.configs import ARCH_IDS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import supports_shape as ref_supports
from repro.core.network import TPU_HBM_BW, TPU_ICI_BW, TPU_PEAK_FLOPS
from repro.launch import roofline as ref

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import roofline as port

TPU = {"peak_flops": TPU_PEAK_FLOPS, "hbm_bw": TPU_HBM_BW,
       "link_bw": TPU_ICI_BW, "fit_bytes": 16 * 2**30}
CELLS = [(a, s) for a in REF_ARCHS for s in REF_SHAPES
         if ref_supports(ref_config(a), s)]


def record(arch, shape, mesh, rng) -> dict:
    """A dry-run record of the keys the roofline reads."""
    devices = 256 if mesh == "single" else 512
    return {"arch": arch, "shape": shape, "mesh": mesh, "devices": devices,
            "optimizer": str(rng.choice(["adamw", "adafactor"])),
            "flops_per_device": float(rng.uniform(1e9, 1e15)),
            "bytes_per_device": float(rng.uniform(1e6, 1e12)),
            "collective_bytes_per_device": float(rng.uniform(0, 1e10)),
            "hbm_per_device": float(rng.uniform(1e8, 1e11)),
            "memory": {"argument_size_in_bytes": int(rng.integers(1e6, 1e10)),
                       "output_size_in_bytes": int(rng.integers(0, 1e9))}}


def test_the_same_archs_and_shapes():
    assert tuple(ARCH_IDS) == tuple(REF_ARCHS)
    assert tuple(SHAPES) == tuple(REF_SHAPES)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_active_params_equal(arch):
    assert port.active_params(arch) == ref.active_params(arch)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_every_function_equals_the_references(arch, shape):
    rng = np.random.default_rng(zlib.crc32(f"{arch}/{shape}".encode()))
    assert port.model_flops(arch, shape) == ref.model_flops(arch, shape)
    for mesh in ("single", "multi"):
        rec = record(arch, shape, mesh, rng)
        assert port.model_traffic_bytes(rec) == ref.model_traffic_bytes(rec)
        assert port.roofline_row(rec, **TPU) == ref.roofline_row(rec)


def test_load_records_and_markdown_table_equal_the_references(tmp_path):
    rng = np.random.default_rng(7)
    names = []
    for arch, shape in CELLS[:6]:
        for mesh in ("single", "multi"):
            names.append((f"{arch}__{shape}__{mesh}", record(arch, shape,
                                                             mesh, rng)))
    arch, shape = CELLS[0]
    # a pipeline cell and a tagged perf-iteration file
    names.append((f"{arch}__{shape}__single_pipe",
                  record(arch, shape, "single", rng)))
    names.append((f"{arch}__{shape}__single_fsdpoff",
                  record(arch, shape, "single", rng)))
    for name, rec in names:
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    for tag in ("", "fsdpoff"):
        got = port.load_records(str(tmp_path), tag)
        assert got == ref.load_records(str(tmp_path), tag)
        assert got
    rows = [ref.roofline_row(r) for r in ref.load_records(str(tmp_path))]
    assert port.markdown_table(rows) == ref.markdown_table(rows)
    ported = [port.roofline_row(r, **TPU)
              for r in port.load_records(str(tmp_path))]
    assert port.markdown_table(ported) == ref.markdown_table(rows)
