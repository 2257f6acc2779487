"""The trace reduction on a hand-made trace: device time by the range its
launch sat in, backward kernels by the autograd node's forward range, each
counted once, busy time as the union of intervals, idle gaps by the range
open at the time."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import trace

CPU, GPU = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, id=-1, seq=-1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, id=id, sequence_nr=seq,
                           is_user_annotation=False)


def test_reduce_attributes_each_kernel_once():
    events = [
        ev(trace.WINDOW_RANGE, 0, 1000),
        ev("train.gcn", 10, 100),
        ev("aten::linear", 20, 30, seq=7), ev("aten::addmm", 21, 29, seq=7),
        ev("cudaLaunchKernel", 22, 23, id=1),
        ev("train.bert", 100, 200), ev("cudaLaunchKernel", 150, 151, id=2),
        ev("train.backward", 300, 500),
        ev("autograd::engine::evaluate_function: AddmmBackward0", 310, 400, seq=7),
        ev("cudaLaunchKernel", 320, 321, id=3),
        ev("gemm", 25, 75, GPU, id=1), ev("bert_gemm", 160, 260, GPU, id=2),
        ev("gemm_bwd", 330, 430, GPU, id=3), ev("Memcpy HtoD", 600, 700, GPU, id=4),
    ]
    tr = trace.reduce(SimpleNamespace(events=lambda: events), ("train.",))
    assert tr.range_device_s == {"train.gcn": pytest.approx(50e-6),
                                 "train.bert": pytest.approx(100e-6)}
    assert tr.backward_device_s == {"train.gcn": pytest.approx(100e-6)}
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx(350e-6)
    assert tr.kernel_s("gemm") == pytest.approx(250e-6)
    assert tr.range_calls == {"train.gcn": 1, "train.bert": 1, "train.backward": 1}
    assert tr.idle_gaps[0][1] == pytest.approx(300e-6)       # 700 -> 1000
    assert tr.idle_gaps[0][0] == "outside the program's ranges"
    assert ["train.gcn", pytest.approx(85e-6)] in tr.idle_gaps    # 75 -> 160
