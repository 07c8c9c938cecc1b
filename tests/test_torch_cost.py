"""The port's step-cost accounting (``repro_torch/utils/cost.py``), the
counterpart of ``tests/test_hlo.py``: ``tensor_bytes`` against the
reference's ``shape_bytes`` over the same dtypes and shapes (``==``); the
FLOPs of one product, of five passes of it (torch counts each pass: no
trip counts), of a product sharded 4 ways on a fake process group (a
quarter on this rank) and of a replicated one (whole); the operand bytes of
an all-reduce, an all-gather and a pipeline hop (``Pipe.bytes``, which no
dispatcher sees); ``op_histogram``; and the kernel wrappers' fake branches
(K2, K2', K3, K3'): outputs in their shapes, no launch counted, their work
charged — K2's and K2''s FLOPs from the query-key pairs the mask keeps,
counted here pair by pair.
"""

import pytest
import torch
import torch.distributed as dist

from repro.utils.hlo import shape_bytes

from repro_torch.utils import (CostCounter, op_histogram, step_cost,
                               tensor_bytes)

#: the reference's HLO dtype names and their torch dtypes
DTYPES = {"pred": torch.bool, "s8": torch.int8, "u8": torch.uint8,
          "s16": torch.int16, "u16": torch.uint16, "s32": torch.int32,
          "u32": torch.uint32, "s64": torch.int64, "u64": torch.uint64,
          "f8e4m3fn": torch.float8_e4m3fn, "f8e5m2": torch.float8_e5m2,
          "bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
          "f64": torch.float64, "c64": torch.complex64,
          "c128": torch.complex128}
SHAPES = [(), (1,), (128, 4), (2, 3, 5), (7, 1, 9, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_group():
    from repro_torch.launch.dryrun import fake_process_group
    with fake_process_group(4):
        yield


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_tensor_bytes_equals_the_references_shape_bytes(name):
    for shape in SHAPES:
        hlo = f"{name}[{','.join(map(str, shape))}]{{0}}"
        assert tensor_bytes(shape, DTYPES[name]) == shape_bytes(hlo)
        assert tensor_bytes(torch.empty(shape, dtype=DTYPES[name])) == \
            shape_bytes(hlo)
    # a tuple shape sums its members, as "(f32[2,2], s32[4])"
    pair = (torch.empty(2, 2), torch.empty(4, dtype=torch.int32))
    assert tensor_bytes(pair) == shape_bytes("(f32[2,2], s32[4])")


def test_a_product_and_five_passes_of_it():
    a, b = torch.randn(32, 64), torch.randn(64, 16)
    assert step_cost(lambda: a @ b).flops == 2 * 32 * 64 * 16

    def five():
        for _ in range(5):
            a @ b

    assert step_cost(five).flops == 5 * 2 * 32 * 64 * 16


def test_a_sharded_product_counts_this_ranks_quarter(fake_group):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    whole = 2 * 64 * 128 * 32
    b = DTensor.from_local(torch.randn(128, 32), mesh, [Replicate()],
                           run_check=False)
    rows = DTensor.from_local(torch.randn(16, 128), mesh, [Shard(0)],
                              run_check=False)
    assert tuple(rows.shape) == (64, 128)
    # twice: the first call also plans the op (DTensor runs it on the
    # global shapes once), which must not count
    for _ in range(2):
        assert step_cost(lambda: rows @ b).flops == whole / 4
    rep = DTensor.from_local(torch.randn(64, 128), mesh, [Replicate()],
                             run_check=False)
    assert step_cost(lambda: rep @ b).flops == whole
    # the contraction split 4 ways: a partial sum, a quarter of the work
    cols = DTensor.from_local(torch.randn(64, 32), mesh, [Shard(1)],
                              run_check=False)
    k_rows = DTensor.from_local(torch.randn(32, 32), mesh, [Shard(0)],
                                run_check=False)
    assert step_cost(lambda: cols @ k_rows).flops == 2 * 64 * 128 * 32 / 4


def test_collective_bytes_by_kind(fake_group):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    t = torch.randn(10, 3)
    c = step_cost(lambda: dist.all_reduce(t))
    assert c.collective_by_kind == {"all-reduce": 4 * 30}
    assert c.collective_bytes == 4 * 30
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    x = DTensor.from_local(torch.randn(16, 32), mesh, [Shard(0)],
                           run_check=False)
    c = step_cost(lambda: x.redistribute(mesh, [Replicate()]))
    # the operand is this rank's block, as the HLO's all-gather operand
    assert c.collective_by_kind == {"all-gather": 16 * 32 * 4}
    assert c.collectives.count_by_kind == {"all-gather": 1}


def test_a_pipe_hop_is_a_collective_permute():
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.pipeline.spmd import Pipe, PipelineConfig
    with fake_process_group(2):
        pipe = Pipe(MeshLayout(("stage",), (2,)), PipelineConfig(2, 2),
                    torch.device("cpu"))
        y = torch.randn(4, 8, 16)
        c = step_cost(pipe.forward_hop, y, pipe=pipe)
        assert pipe.bytes["hop"] == 4 * 8 * 16 * 4
        assert c.collective_by_kind == {"collective-permute": 4 * 8 * 16 * 4}


def test_op_histogram():
    a, b = torch.randn(8, 8), torch.randn(8, 8)

    def step():
        for _ in range(5):
            a @ b
        torch.relu(a)
        torch.relu(b)

    c = step_cost(step)
    assert op_histogram(c, top=2) == [("mm", 5), ("relu", 2)]
    assert op_histogram(c.ops) == op_histogram(c)


def test_the_flops_by_product_sum_to_the_count():
    a, b, w = torch.randn(8, 16), torch.randn(16, 4), torch.randn(3, 8, 16)
    with CostCounter(breakdown=True) as c:
        with c.repeat(3):
            a @ b
        torch.bmm(w, b.expand(3, 16, 4))
        torch.relu(a)
    rows = c.flops_by_op()
    assert rows == [
        {"op": "mm", "shapes": [[8, 16], [16, 4]], "count": 3,
         "flops": 3 * 2 * 8 * 16 * 4},
        {"op": "bmm", "shapes": [[3, 8, 16], [3, 16, 4]], "count": 1,
         "flops": 2 * 3 * 8 * 16 * 4}]
    assert sum(r["flops"] for r in rows) == c.flops
    assert c.flops_by_op(top=1) == rows[:1]
    # without a breakdown nothing is kept
    with CostCounter() as plain:
        a @ b
    assert plain.flops_by_op() == []


def pairs_counted(S, T, causal, window):
    """The kept query-key pairs, one by one."""
    return sum(1 for s in range(S) for t in range(T)
               if (not causal or t <= s)
               and (window <= 0 or t > s - window))


@pytest.mark.parametrize("S,T,causal,window", [
    (64, 64, True, 0), (77, 77, True, 0), (40, 64, False, 0),
    (96, 96, True, 17)])
def test_k2_and_k2_bwd_fake_branches_charge_the_kept_pairs(S, T, causal,
                                                           window):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash
    B, H, KV, hd = 2, 4, 2, 32
    fwd, bwd = flash.flash_attention.launches, \
        flash.flash_attention_bwd.launches
    with FakeTensorMode(), torch.no_grad():
        q = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(B, T, KV, hd, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(B, H, S, device="cuda")
        with CostCounter() as c:
            o = flash.flash_attention(q, k, k, causal=causal, window=window)
            grads = flash.flash_attention_bwd(q, k, k, o, o, lse,
                                              causal=causal, window=window)
    pairs = pairs_counted(S, T, causal, window)
    assert c.kernels["flash_attention"]["flops"] == 4 * hd * pairs * B * H
    assert c.kernels["flash_attention_bwd"]["flops"] == \
        10 * hd * pairs * B * H
    assert c.flops == 14 * hd * pairs * B * H
    assert o.shape == q.shape and o.device.type == "cuda"
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    # nothing launched
    assert (flash.flash_attention.launches,
            flash.flash_attention_bwd.launches) == (fwd, bwd)


def test_k3_and_k3_bwd_fake_branches_charge_their_work():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import rwkv6
    from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_cost, wkv6_cost
    B, S, H, hd = 1, 128, 2, 64
    launches = rwkv6.wkv6.launches, rwkv6.wkv6_bwd.launches
    with FakeTensorMode(), torch.no_grad():
        r = torch.empty(B, S, H, hd, device="cuda")
        u = torch.empty(H, hd, device="cuda")
        s0 = torch.empty(B, H, hd, hd, device="cuda")
        with CostCounter() as c:
            y, s_out = rwkv6.wkv6(r, r, r, r, u, s0)
            grads = rwkv6.wkv6_bwd(r, r, r, r, u, s0, y, s_out)
    # two 64-token tiles: 4 n hd^2 + 2 n (n - 1) hd + 8 n hd + hd^2 each
    tile = 4 * 64 * hd * hd + 2 * 64 * 63 * hd + 8 * 64 * hd + hd * hd
    assert wkv6_cost(B, S, H, hd, torch.float32)[0] == 2 * tile * B * H
    assert c.kernels["wkv6"]["flops"] == 2 * tile * B * H
    assert c.kernels["wkv6_bwd"]["flops"] == \
        wkv6_bwd_cost(B, S, H, hd, torch.float32)[0] == \
        10 * hd * hd * B * S * H
    assert y.shape == r.shape and s_out.shape == s0.shape
    assert len(grads) == 6
    assert (rwkv6.wkv6.launches, rwkv6.wkv6_bwd.launches) == launches
