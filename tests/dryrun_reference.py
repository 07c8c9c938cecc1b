"""The reference's dry run of reduced cells, for the port's dry-run tests
(``tests/test_torch_dryrun_*.py``) and for comparing one cell by hand.

Each cell is lowered and compiled by the reference's own
``repro/launch/dryrun.py::_lower_cell`` / ``_lower_pipeline_cell`` on host
devices, with the config reduced (``get_config(arch, reduced=True)`` and
the cell's overrides) and the shape's batch and length overridden; the
records are printed as one JSON list on the last line, each with the
reference's cache shapes (``cache_specs``) for a serving cell.

Usage (from the repository root; imports JAX, so never from the port)::

    python tests/dryrun_reference.py '[{"arch": "qwen3-0.6b",
        "shape": "train_4k", "axes": ["pod", "data", "model"],
        "sizes": [2, 2, 2], "batch": [8, 32], "q": 4,
        "over": {"remat": "none"}}]'

A cell's keys: ``arch``, ``shape``, ``axes``, ``sizes``, ``batch`` ([B,
S]), and optionally ``q`` (micro-batches), ``over`` (config fields),
``pipeline`` (true: the paper-mode train cell, ``axes`` holding "stage"),
``reduced`` (false: the full config) and ``dots`` (N: the record's
``dots`` lists the compiled step's N largest products, each
[FLOPs a device with its loops' trip counts, computation, lhs, rhs and
output dims]).  The port's side of a cell is
``test_torch_dryrun.py::trace``.
"""

import dataclasses
import json
import os
import sys


def lower(cells: list) -> list:
    devices = max(_size(c) for c in cells)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import repro.launch.dryrun as ref_dryrun   # sets XLA_FLAGS to 512
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={devices}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import repro.configs.base as ref_base
    from repro.configs import cache_specs, get_config
    from repro.launch.compat import AxisType, make_mesh
    shapes = dict(ref_base.SHAPES)
    hlo_cost = ref_dryrun.hlo_cost
    texts = []

    def keep_text(text):
        texts[:] = [text]
        return hlo_cost(text)
    ref_dryrun.hlo_cost = keep_text
    out = []
    for c in cells:
        over = c.get("over", {})
        cfg = dataclasses.replace(
            get_config(c["arch"], reduced=c.get("reduced", True)), **over)
        sp = dataclasses.replace(shapes[c["shape"]],
                                 global_batch=c["batch"][0],
                                 seq_len=c["batch"][1])
        ref_base.SHAPES[c["shape"]] = sp
        ref_dryrun.get_config = lambda _arch, _cfg=cfg: _cfg
        mesh = make_mesh(tuple(c["sizes"]), tuple(c["axes"]),
                         axis_types=(AxisType.Auto,) * len(c["axes"]))
        if c.get("pipeline"):
            rec = ref_dryrun._lower_pipeline_cell(
                c["arch"], mesh, num_stages=dict(
                    zip(c["axes"], c["sizes"]))["stage"], q=c.get("q", 1))
        else:
            rec = ref_dryrun._lower_cell(c["arch"], c["shape"], mesh,
                                         q_override=c.get("q"))
        if sp.kind != "train":
            cfg_srv = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
            rec["cache_shapes"] = jax.tree.map(
                lambda s: list(s.shape), cache_specs(cfg_srv, c["shape"]))
        ref_base.SHAPES[c["shape"]] = shapes[c["shape"]]
        if c.get("dots"):
            rec["dots"] = dots(texts[-1])[:c["dots"]]
        out.append(rec)
    return out


def dots(hlo_text: str) -> list:
    """Every product of a compiled module, largest first: [FLOPs a device
    (times the trip counts of the loops around it), computation, lhs dims,
    rhs dims, output dims], counted as the reference's ``hlo_cost``
    counts them."""
    import re
    from repro.utils import hlo
    comps = hlo._parse_computations(hlo_text)
    found = []

    def walk(name, mult, seen):
        instrs = comps.get(name, [])
        dims = {i.name: i.out_dims for i in instrs}
        for ins in instrs:
            if ins.opcode == "dot":
                lhs, rhs = (list(dims.get(o, ())) for o in
                            (ins.operand_names + ["", ""])[:2])
                found.append([mult * hlo._dot_flops(ins, dims), name, lhs,
                              rhs, list(ins.out_dims)])
            for callee in re.findall(r"(?:to_apply|calls)=%?([\w.\-]+)",
                                     ins.line):
                if callee in comps and callee not in seen:
                    walk(callee, mult, seen | {callee})
            if ins.opcode == "while":
                body = re.search(r"body=%?([\w.\-]+)", ins.line).group(1)
                cond = re.search(r"condition=%?([\w.\-]+)",
                                 ins.line).group(1)
                trips = hlo._trip_count(ins.line, comps.get(cond, []))
                walk(body, mult * trips, seen | {body})
    walk(next(n for n in comps if n.startswith("main")), 1.0, set())
    return sorted(found, key=lambda d: -d[0])


def _size(cell) -> int:
    n = 1
    for s in cell["sizes"]:
        n *= s
    return n


if __name__ == "__main__":
    print(json.dumps(lower(json.loads(sys.argv[1]))))
