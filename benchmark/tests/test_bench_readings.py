"""The statistics and the readers' arithmetic, against hand counts."""

import json
import types

import pytest
import torch

from dfbench import loop, peaks, trace


def test_p95_over_every_frame():
    lat = list(range(1, 101))  # 1 .. 100 ms
    # numpy's linear interpolation: rank 0.95 * 99 = 94.05 -> 95.05
    assert loop.p95(lat) == pytest.approx(95.05)
    assert loop.p95([5.0] * 19 + [500.0]) == pytest.approx(5.0 + 0.05 * 495)


def test_union_counts_overlaps_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert trace.union_length(iv) == 15 + 10 + 1
    assert trace.gaps(iv, 0, 50) == [(15, 20), (30, 40), (41, 50)]


def test_idle_share_from_a_trace(tmp_path):
    """Two overlapping kernels and a copy in a 100 us window: busy 30 us,
    idle 70 %; launches 2; the idle gaps named by the host range."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/window",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1,
         "dur": 2, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 15, "dur": 10,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 50,
         "dur": 10, "args": {}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 30,
         "dur": 60, "tid": 1},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.Trace(p)
    spans = types.SimpleNamespace(args={}, host={})
    r = trace.RunReadings(tr, 2, spans, 0, 0, 0, [])
    assert r.busy_s == pytest.approx(30e-6)
    assert r.window_s == pytest.approx(100e-6)
    assert r.launches == 2
    idle = dict(tr.idle_by_host(0, 100))
    # each gap goes whole to the innermost host range at its midpoint:
    # 30..50 and 60..100 to aten::item (30..90), 0..10 to the window
    assert idle["aten::item"] == pytest.approx(60e-6)
    assert idle["bench/window"] == pytest.approx(10e-6)
    reader = loop.load_reader("idle_share")
    assert reader.read(r) == pytest.approx(70.0)


def test_integrate_bytes_by_hand():
    m = loop.load_reader("integrate_roofline")
    vol = types.SimpleNamespace(tsdf=torch.zeros((4, 5, 6),
                                                 dtype=torch.float16))
    dists = torch.zeros((3, 2))
    # fresh: dists read (6 x 4 B), tsdf (2 B) and weight (1 B) written
    assert m.cost((vol, dists, None, None, None), {"fresh": True}) == (
        24 + 120 * 3, 120 * 20)
    # averaging into the volume reads it too
    assert m.cost((vol, dists, None, None, None, False), {})[0] == 24 + 720


def test_data_gram_bytes_and_operations_by_hand():
    m = loop.load_reader("data_gram_roofline")
    idx = torch.tensor([[0, 1, 9], [2, -1, 3]], dtype=torch.int32)
    s2 = torch.tensor([1.0, 0.0])
    D = 4
    nbytes, ops = m.cost((idx, None, s2, None, D), {})
    # indices and weights 2 x 3 x 8 B, s2 and delta 2 x 16 B, the (4, 4)
    # Gram and (4, 3) right-hand side 28 x 4 B
    assert nbytes == 48 + 32 + 112
    # row 0 has 2 valid slots (9 is out of range), row 1 has s2 = 0
    assert ops == 2 * 2 * 2 + 2 * 7


def test_stencil_bytes_by_hand():
    m = loop.load_reader("stencil_roofline")
    img = torch.zeros((2, 3, 6))
    assert m.cost((img, None, None, 2), {}) == (6 * (8 + 48), 0)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12 * 2) == pytest.approx(2.0)
