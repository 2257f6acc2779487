"""The readers of the program's host spans and fill counters on a hand-made
trace and counter registry: each reads its ranges a call or a step, or its
counters' share, and nothing where the program has no such span or counter
(as a program without them has not)."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.trace import Trace

FILLS = {
    "text_fill.export": ("text.tokens", "text.slots"),
    "text_fill.train": ("text.tokens", "text.slots"),
    "node_fill.export": ("graph.nodes", "graph.node_slots"),
    "node_fill.train": ("graph.nodes", "graph.node_slots"),
    "edge_fill.train": ("graph.edges", "graph.edge_slots"),
    "code_fill.export": ("quantize.codes", "quantize.code_slots"),
}


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


@pytest.fixture
def registry(monkeypatch):
    from medtok_tpu_torch.utils import profiling

    held = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(held))
    return held


def test_prep_ms_export_reads_plan_and_finish_a_call():
    tr = Trace(range_host_s={"export.plan": 0.3, "export.finish": 0.006, "export.bert": 9.0},
               range_calls={"export.plan": 3, "export.finish": 3, "export.bert": 30})
    assert reader("prep_ms.export").read({"trace": tr, "steps": 30}) == pytest.approx(102.0)
    del tr.range_calls["export.finish"]
    assert reader("prep_ms.export").read({"trace": tr, "steps": 30}) is None
    assert reader("prep_ms.export").read({"trace": None, "steps": 0}) is None


def test_host_ms_train_reads_draws_over_whole_draws_and_the_rest_by_calls():
    tr = Trace(range_host_s={"train.draw": 0.175 + 1e-5, "train.pack": 0.04,
                             "train.to_device": 0.08, "train.bert": 1.0},
               range_calls={"train.draw": 8, "train.pack": 8, "train.to_device": 8})
    # 7 whole draws of 25 ms (the eighth cut at the profiler's stop), packs
    # of 5 ms, copies of 10
    got = reader("host_ms.train").read({"trace": tr, "steps": 8})
    assert got == pytest.approx(40.0, abs=0.01)
    del tr.range_calls["train.draw"]
    assert reader("host_ms.train").read({"trace": tr, "steps": 8}) is None


@pytest.mark.parametrize("name", sorted(FILLS))
def test_fill_reads_the_counters_share(name, registry, monkeypatch):
    from medtok_tpu_torch.utils import profiling

    real, slots = FILLS[name]
    assert reader(name).read({"trace": None}) is None
    registry.update({real: 30, slots: 1200, "other.slots": 7})
    assert reader(name).read({"trace": None}) == pytest.approx(2.5)
    monkeypatch.delattr(profiling, "counters")      # a program without the registry
    assert reader(name).read({"trace": None}) is None
