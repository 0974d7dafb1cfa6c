"""The yardstick's operation and byte counts against hand-worked shapes, and
the trace reduction on hand-made events."""

import pytest

from benchmark.yardstick import counts as K
from benchmark.yardstick import trace as Y


def test_conv_list_of_a_two_level_net():
    convs = K.subm_convs([100, 20], [900, 150], channels=8, num_blocks=2)
    # input conv, 4 head + 1 concat + 3 tail convs at level 0, 4 at level 1
    assert len(convs) == 1 + 8 + 4
    assert convs[0] == (100, 900, 27, 4, 8)
    assert convs[1:5] == [(100, 900, 27, 8, 8)] * 4
    assert convs[5] == (100, 900, 27, 16, 8)
    assert convs[-1] == (20, 150, 27, 16, 16)


def test_53_convs_of_the_published_net():
    v = [1000] * 7
    assert len(K.subm_convs(v, v)) == 53


def test_conv_least_time_by_hand():
    # 2 * nnz * Cin * Cout = 2 * 1e6 * 32 * 32 operations
    flops = 2 * 1e6 * 32 * 32
    nbytes = 1e5 * 32 * 2 + 27 * 32 * 32 * 2 + 27 * 1e5 * 4 + 1e5 * 32 * 2
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert K.conv_least_s(1e5, 1e6, 27, 32, 32) == pytest.approx(want)
    # bytes bound it here
    assert nbytes / 3.35e12 > flops / 989e12
    dw = max(flops / 989e12,
             (1e5 * 32 * 2 * 2 + 27 * 1e5 * 4 + 27 * 32 * 32 * 4) / 3.35e12)
    assert K.dw_least_s(1e5, 1e6, 27, 32, 32) == pytest.approx(dw)


def test_flops_by_hand_one_level():
    # one level, C = 2, 4 convs of nnz * C * C MACs, input conv 4 -> 2,
    # heads n * (C C + 2 C + C C + 3 C) MACs; 2 FLOPs a MAC
    f = K.analytic_model_flops([10], [50], 7, channels=2, num_blocks=1)
    assert f == 2 * (50 * 4 * 2 + 4 * 50 * 2 * 2 + 7 * (4 + 4 + 4 + 6))
    t = K.train_step_flops([10], [50], 7, channels=2, num_blocks=1)
    assert t == 3 * f - 2 * 50 * 4 * 2


def test_backward_counts_skip_the_input_dx():
    dx, dw = K.backward_least_s(([100, 20], [900, 150]), channels=8,
                                num_blocks=2)
    convs = K.subm_convs([100, 20], [900, 150], channels=8, num_blocks=2)
    assert dx == pytest.approx(sum(K.conv_least_s(v, n, k, co, ci)
                                   for v, n, k, ci, co in convs[1:]))
    assert dw == pytest.approx(sum(K.dw_least_s(*c) for c in convs))


def test_trace_summary_by_hand():
    ev = {"device": [(100, 200, "void k<1>(int)"), (150, 300, "k2"),
                     (500, 600, "void k<2>(float)")],
          "spans": [(0, 1000, "window"), (300, 480, "step.backward")]}
    s = Y.summarize(ev, 0, 1000, stages=[(400, "a"), (1000, "b")])
    cut = Y.summarize(ev, 0, 1000, stages=[(350, "a"), (1000, "b")])
    pieces = dict((k, v) for k, v in cut["idle_gaps"])
    # the gap 300-500 is cut at 350: 50 ns in stage a, 150 ns in stage b
    assert pieces["a/step.backward"] == pytest.approx(50e-9)
    assert pieces["b/step.backward"] == pytest.approx(150e-9)
    assert pieces["b/window"] == pytest.approx(400e-9)
    assert s["busy_s"] == pytest.approx(300e-9)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert dict((k, v) for k, v in s["device_ops"])["k"] == pytest.approx(200e-9)
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps["a/window"] == pytest.approx(100e-9)
    assert gaps["a/step.backward"] == pytest.approx(100e-9)
    assert gaps["b/step.backward"] == pytest.approx(100e-9)
    assert gaps["b/window"] == pytest.approx(400e-9)
    assert Y.span_seconds(ev, "step.backward", 0, 1000) == [pytest.approx(180e-9)]
    assert Y.kernel_seconds(ev, "k", 0, 1000)[1] == 3
