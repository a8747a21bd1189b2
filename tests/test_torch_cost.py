"""``repro_torch.launch.cost`` / ``roofline`` on analytically known programs,
mirroring the reference's ``tests/test_roofline.py``: looped and nested
matmuls count exactly, a sliced read is charged the slice, a cross-position
sum charges its payload once, the collective accounting agrees with the
reference's ring rule, and each kernel's cost function equals a hand count
and is what its wrapper charges."""
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import collective_bytes as ref_collective_bytes
from repro_torch.launch import cost, roofline


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_matmul_flops_exact(device):
    x = torch.ones(256, 256, device=device)
    ws = torch.ones(12, 256, 256, device=device)

    def looped(x, ws):
        for i in range(ws.shape[0]):
            x = x @ ws[i]
        return x

    pc = cost.rollup(looped, x, ws)
    assert pc.flops == 12 * 2 * 256**3
    assert pc.mm_flops == 0  # float32 matmuls are charged as scalar work
    assert pc.hbm_bytes == 12 * 3 * 256 * 256 * 4  # each matmul: two operands, one result


def test_nested_loops_multiply():
    x = torch.ones(128, 128, dtype=torch.bfloat16, device="meta")
    ws = torch.ones(3, 4, 128, 128, dtype=torch.bfloat16, device="meta")

    def nested(x, ws):
        for g in range(ws.shape[0]):
            for i in range(ws.shape[1]):
                x = x @ ws[g, i]
        return x

    pc = cost.rollup(nested, x, ws)
    assert pc.flops == pc.mm_flops == 12 * 2 * 128**3  # bfloat16: tensor cores


def test_bytes_slice_not_whole_operand():
    """Reading an (L, n, n) stack a slice a step costs ~L·n², not L·(L·n²)."""
    n, L = 512, 16
    x, ws = torch.ones(n, n, device="meta"), torch.ones(L, n, n, device="meta")

    def looped(c, ws):
        for i in range(L):
            c = c * 0.5 + ws[i]
        return c

    pc = cost.rollup(looped, x, ws)
    slice_traffic = L * n * n * 4
    assert slice_traffic < pc.hbm_bytes < 8 * slice_traffic
    assert pc.hbm_bytes == 5 * slice_traffic  # mul: read c, write; add: read two, write
    assert pc.flops == 2 * L * n * n


def test_views_and_empty_are_free():
    x = torch.ones(64, 64)

    def views(x):
        return x[1:9].reshape(-1).view(8, 64).t().detach(), torch.empty(100)

    pc = cost.rollup(views, x)
    assert pc.hbm_bytes == 0 and pc.flops == 0


def test_cross_position_sum_charges_payload_once():
    from repro_torch.core.hprepost import HPrepostMiner
    from repro_torch.launch.mesh import make_mesh

    miner = HPrepostMiner(mesh=make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"]))
    rows = np.random.default_rng(0).integers(-1, 50, size=(40, 6)).astype(np.int32)
    shards = miner._shard_rows(rows)
    hist, pc = cost.trace(miner._job1, shards, 50)
    assert pc.coll_payload == {"all-reduce": 50 * 4}
    assert pc.wire_bytes == 50 * 4  # shard 1's counts leave its position, shard 0's are there
    # the histogram kernels charge their own cost, once a shard
    assert pc.flops >= 2 * 20 * 6


def test_collective_bytes_agrees_with_reference_ring_rule():
    payload = {"all-reduce": 64 * 64 * 4, "all-gather": 128 * 4, "collective-permute": 32 * 8 * 4}
    dims = {"all-reduce": "64,64", "all-gather": "128", "collective-permute": "32,8"}
    hlo = "\n".join(f"  %c{i} = f32[{dims[op]}]{{0}} {op}(f32[{dims[op]}]{{0}} %p{i}), channel_id={i}"
                    for i, op in enumerate(payload))
    want = ref_collective_bytes(hlo)
    got = roofline.collective_bytes(payload)
    assert got == want
    assert got["wire_bytes"] == 2 * 64 * 64 * 4 + 128 * 4 + 32 * 8 * 4


def test_roofline_terms():
    pc = cost.ProgramCost(flops=2e12, hbm_bytes=3.35e12, coll_payload={}, wire_bytes=0.0, mm_flops=1e12)
    roof = roofline.analyze(pc)
    assert roof.t_memory == pytest.approx(1.0)
    assert roof.t_compute == pytest.approx(max(1e12 / 989.4e12, 1e12 / 67e12))
    assert roof.bottleneck == "memory"
    assert roofline.bound_ms(3.35e9, 1) == (pytest.approx(1.0), "bytes")
    assert roofline.bound_ms(1, 67e9) == (pytest.approx(1.0), "operations")


def test_histogram_cost_hand_count():
    from repro_torch.kernels.histogram.kernel import histogram_cuda
    from repro_torch.kernels.histogram.ops import histogram_cost

    rows = torch.tensor([[0, 1, -1, -1], [2, 2, 1, -1], [3, -1, -1, -1]], dtype=torch.int32)
    w = torch.ones(3, dtype=torch.int32)
    assert histogram_cost(rows, w, n_bins=5) == (3 * 4 * 4 + 3 * 4 + 5 * 4, 12)
    _, pc = cost.trace(histogram_cuda, rows, w, n_bins=5)
    assert (pc.hbm_bytes, pc.flops) == histogram_cost(rows, w, n_bins=5)  # the route's ops uncharged


def test_cooccur_cost_hand_count():
    from repro_torch.kernels.cooccur.kernel import cooccur_cuda
    from repro_torch.kernels.cooccur.ops import cooccur_cost

    rows = torch.tensor([[0, 1, -1], [2, -1, -1], [0, 1, 2]], dtype=torch.int32)
    w = torch.ones(3, dtype=torch.int32)
    assert cooccur_cost(rows, w, n_items=3) == (3 * 3 * 4 + 3 * 4 + 9 * 4, 4 + 1 + 9)
    _, pc = cost.trace(cooccur_cuda, rows, w, n_items=3)
    assert (pc.hbm_bytes, pc.flops) == cooccur_cost(rows, w, n_items=3)


def _tiny_wave():
    big = np.iinfo(np.int32).max
    planes = torch.tensor([
        [[1, 5, big, big], [2, 3, 6, big]],  # pre
        [[9, 4, -1, -1], [3, 1, 5, -1]],  # post
        [[2, 3, 0, 0], [1, 1, 4, 0]],  # count
    ], dtype=torch.int32)
    idx = torch.tensor([[0], [0], [1]], dtype=torch.int64)  # parent 0, base item 0, extension item 1
    return planes, idx


def test_wave_cost_hand_count():
    """A: item 1 (3 valid slots), Y: item 0 (2 valid, both counts nonzero),
    the parent's state the count plane itself: pre/post of 3 + 2 slots, the
    2 Y counts once, one (1, 4) output row and support, 3 index entries;
    2 nonzero Y codes × (log2 4 + 2) operations."""
    from repro_torch.kernels.nlist_intersect.kernel import nlist_wave_cuda
    from repro_torch.kernels.nlist_intersect.ops import wave_cost

    planes, idx = _tiny_wave()
    want = (8 * 5 + 4 * 2 + 1 * 4 * 4 + 1 * 4 + 3 * 1 * 8, 2 * 4)
    assert wave_cost(planes, planes[2], idx, 1) == want
    _, pc = cost.trace(nlist_wave_cuda, planes, planes[2], idx, 1)
    assert (pc.hbm_bytes, pc.flops) == want
    # early stop at a threshold nothing reaches: A's counts are read too
    nb, ops = wave_cost(planes, planes[2], idx, 1, early_stop=True, min_count=100, la_block=1)
    assert nb >= want[0] - 8 * 3 and ops <= want[1]


def test_no_recorder_no_charge():
    from repro_torch.kernels.nlist_intersect.kernel import nlist_wave_cuda

    planes, idx = _tiny_wave()
    assert cost.active() is None
    nlist_wave_cuda(planes, planes[2], idx, 1)  # nothing to charge, nothing raised
    cost.collective("all-reduce", 4, 4)
