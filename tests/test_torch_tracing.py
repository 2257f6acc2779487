"""The port's spans and counters (``medtok_tpu_torch/utils/profiling.py``) on
the CPU at tiny sizes: ``Trainer.fit`` and both export routes open each host
phase's range once per step or call under a profiler, and no new range
encloses one that was there before; ``span`` opens no ``record_function``
without a profiler; the fill counters equal counts made by hand from the
batches (export: native and numpy routes, packed and unpacked; two ``fit``
steps), the same with the profiler on or off; ``trace`` writes the
registry's change beside its Chrome trace."""

import contextlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import medtok_tpu_torch
from medtok_tpu_torch.config import DataConfig, MedTokConfig, TrainConfig
from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
from medtok_tpu_torch.export import code_buckets, export_all, export_all_packed, export_groups
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.train.trainer import Trainer
from medtok_tpu_torch.utils import profiling
from tests.test_torch_train_fit import KG_NODES, tiny_model

DATA = DataConfig(text_buckets=(8, 16, 32), node_buckets=(8, 16), edge_buckets=(16, 64),
                  max_text_length=32)
PACK = dict(row_len=32, num_rows=4)
BATCH = 8
FIT_SPANS = ("train.draw", "train.pack", "train.to_device", "train.metrics")
EXPORT_SPANS = ("export.plan", "export.finish")
FILL = ("text.tokens", "text.slots", "graph.nodes", "graph.node_slots", "graph.edges",
        "graph.edge_slots", "quantize.codes", "quantize.code_slots")


@pytest.fixture(scope="module")
def parts():
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    rng = np.random.default_rng(3)
    cols = synthetic_vocab_columns(rng, num_codes=20, num_kg_nodes=KG_NODES, max_pkg_nodes=12)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=8_000, local_frac=0.8)
    return kg, cols, WordPieceTokenizer(vocab)


def make_dataset(parts, native=True):
    kg, cols, tokenizer = parts
    ds = MedCodeDataset.from_columns(kg, cols, tokenizer, cfg=DATA, native=native)
    ds.warm_cache()
    return ds


@pytest.fixture(scope="module")
def model():
    return MultimodalTokenizer(tiny_model()).eval()


def profiled(fn):
    """(fn's result, the profile's host events) under a CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]


def assert_leaves(events, new, prefixes):
    """No range named in ``new`` holds a range of the program that is not."""
    old = [e for e in events if e.name.startswith(prefixes) and e.name not in new]
    assert old
    for name in new:
        for s, t in ranges(events, name):
            inside = [e.name for e in old if s <= e.time_range.start and e.time_range.end <= t]
            assert not inside, f"{name} encloses {inside}"


def delta(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in FILL}


def fit_two_steps(parts, tmp_path, native=True):
    """Two packed fit steps over prebuilt batches; (trainer, the batches,
    the fill counters' change over building and training)."""
    ds = make_dataset(parts, native)
    cfg = MedTokConfig(model=tiny_model(), data=DATA,
                       train=TrainConfig(global_batch_size=BATCH, packed_text=True,
                                         packed_row_len=32, log_every=1, ckpt_every=2))
    trainer = Trainer(cfg, device="cpu", workdir=tmp_path)
    state = trainer.init_state()
    before = profiling.counters()
    batches = list(epoch_batches(ds, batch_size=BATCH, seed=0))[:2]
    trainer.fit(state, iter(batches), max_steps=2)
    return trainer, batches, delta(before)


def test_fit_spans_once_a_step_and_enclose_no_range(parts, tmp_path):
    _, events = profiled(lambda: fit_two_steps(parts, tmp_path))
    for name in FIT_SPANS:
        assert len(ranges(events, name)) == 2, name
    assert len(ranges(events, "train.checkpoint")) == 1
    assert_leaves(events, FIT_SPANS + ("train.checkpoint",), ("train.", "gcn_norm_adj"))


@pytest.mark.parametrize("packed", [True, False])
def test_export_spans_once_a_call_and_enclose_no_range(parts, model, packed):
    ds = make_dataset(parts)

    def twice():
        for _ in range(2):
            if packed:
                export_all_packed(model, ds, device="cpu", **PACK)
            else:
                export_all(model, ds, batch_size=BATCH, device="cpu")

    _, events = profiled(twice)
    for name in EXPORT_SPANS:
        assert len(ranges(events, name)) == 2, name
    assert_leaves(events, EXPORT_SPANS, ("export.", "gcn_norm_adj"))


def test_span_opens_no_range_without_a_profiler(parts, model, tmp_path, monkeypatch):
    opened = []

    def record_function(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(profiling, "record_function", record_function)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    fit_two_steps(parts, tmp_path)
    export_all_packed(model, make_dataset(parts), device="cpu", **PACK)
    assert opened == []
    profiled(lambda: profiling.span("c"))
    assert opened == ["c"]


def test_every_range_of_the_port_opens_through_span():
    root = Path(medtok_tpu_torch.__file__).parent
    direct = re.compile(r"import .*record_function|profiler\.record_function")
    assert [p.relative_to(root).as_posix() for p in root.rglob("*.py")
            if direct.search(p.read_text())] == ["utils/profiling.py"]


def hand_graph(ds, codes, real, ln, epg, views=1):
    """The fill of one built batch counted from the KG: each real code's
    node list cut to ln, its induced edges cut to epg."""
    nodes = [np.sort(np.asarray(ds.pkg_index_lists[i], np.int64))[:ln] for i in codes[:real]]
    edges = sum(min(len(ds.kg.induced_subgraph(n)[0]), epg) for n in nodes)
    return {"graph.nodes": sum(len(n) for n in nodes), "graph.node_slots": len(codes) * ln,
            "graph.edges": views * edges, "graph.edge_slots": views * len(codes) * epg}


def add(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("native", [True, False])
def test_export_counters_equal_hand_counts(parts, model, monkeypatch, native, packed):
    ds = make_dataset(parts, native)
    built = []      # (codes, real, Ln, Epg) of each batch the export built
    for name in ("make_batch", "make_batch_compact"):
        orig = getattr(ds, name)

        def spy(indices, *a, _orig=orig, real=None, **kw):
            out = _orig(indices, *a, real=real, **kw)
            b = out if hasattr(out, "node_ids") else out[0]
            B, ln = b.node_ids.shape
            epg = (b.edge_weight.size if hasattr(b, "edge_weight") else b.edge_packed.numel()) // B
            built.append((list(indices), real, ln, epg))
            return out

        monkeypatch.setattr(ds, name, spy)

    def run():
        if packed:
            return export_all_packed(model, ds, device="cpu", **PACK)
        return export_all(model, ds, batch_size=BATCH, device="cpu")

    before = profiling.counters()
    run()
    plain = delta(before)
    want = {k: 0 for k in FILL}
    for codes, real, ln, epg in built:
        add(want, hand_graph(ds, codes, real, ln, epg))
    if packed:
        groups = export_groups(ds, **PACK)
        assert len(built) == len(groups)
        for g, (codes, real, _, _) in zip(groups, built):
            assert real == len(g) and len(codes) in code_buckets(len(ds))
            add(want, {"text.tokens": sum(len(ds.text_ids(int(i))) for i in g),
                       "text.slots": PACK["row_len"] * PACK["num_rows"],
                       "quantize.codes": len(g), "quantize.code_slots": len(codes)})
        assert want["quantize.codes"] == len(ds) < want["quantize.code_slots"]
    else:
        assert [r for _, r, _, _ in built] == [8, 8, 4]
    assert plain == want
    built.clear()
    before = profiling.counters()
    profiled(run)
    assert delta(before) == want


@pytest.mark.parametrize("native", [True, False])
def test_fit_counters_equal_hand_counts(parts, tmp_path, native):
    trainer, batches, plain = fit_two_steps(parts, tmp_path / "off", native)
    want = {k: 0 for k in FILL}
    for b in batches:
        add(want, {"text.tokens": int(b.attention_mask.sum()),
                   "text.slots": trainer.pack_rows * 32,
                   "graph.nodes": int(b.node_mask.sum()), "graph.node_slots": b.node_mask.size,
                   "graph.edges": int((b.edge_weight > 0).sum() + (b.edge_weight_aug > 0).sum()),
                   "graph.edge_slots": 2 * b.edge_weight.size})
    assert want["graph.edges"] < want["graph.edge_slots"]
    assert plain == want
    (_, _, traced), _ = profiled(lambda: fit_two_steps(parts, tmp_path / "on", native))
    assert traced == want


def test_trace_writes_the_counters_change(tmp_path):
    profiling.count("test.trace.before", 5)
    with profiling.trace(tmp_path / "prof"):
        with profiling.span("test.trace.span"):
            profiling.count("test.trace.inside", 3)
            profiling.count("test.trace.inside", 0.5)
    moved = json.loads((tmp_path / "prof" / "counters.json").read_text())
    assert moved == {"test.trace.inside": 3.5}
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1
