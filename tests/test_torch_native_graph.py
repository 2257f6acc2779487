"""The port's native graph runtime (``medtok_tpu_torch/data/native.py`` over
its own build of ``csrc/host/medtok_graph.cpp``) against the JAX package's
``NativeGraph``, bit for bit on one KG: induced subgraphs, the classic pack
with and without edge dropout, the packer's thread count, each compact
encoding, the stream pack, edge counts and truncation; then the pools'
recycling, depth and fences."""

import numpy as np
import pytest
import torch

from medtok_tpu.data.native import NativeGraph as JaxNativeGraph
from medtok_tpu_torch.data.native import NativeGraph
from medtok_tpu_torch.data.synthetic import synthetic_kg, synthetic_vocab_columns
from medtok_tpu_torch.utils.profiling import counters

KG_NODES = 4000


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(5)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=60_000, local_frac=0.8)
    cols = synthetic_vocab_columns(rng, num_codes=300, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=40, heavy_tail=True)
    nodes = [np.asarray(n, np.int64) for n in cols["pkg_index_list"]]
    args = (kg.edge_src, kg.edge_dst, kg.rel_index, kg.num_nodes)
    off = np.zeros(len(nodes) + 1, np.int64)
    np.cumsum([len(n) for n in nodes], out=off[1:])
    arena = np.concatenate(nodes).astype(np.int32)
    return dict(kg=kg, nodes=nodes, port=NativeGraph(*args), jax=JaxNativeGraph(*args),
                arena=arena, off=off)


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        if want[name] is None:
            assert got[name] is None, name
        else:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]),
                                          err_msg=name)
            assert np.asarray(got[name]).dtype == np.asarray(want[name]).dtype, name


def test_induced_subgraph_matches_jax_and_numpy(graphs):
    for i in (0, 7, 42, 123, 299):
        nodes = graphs["nodes"][i]
        got = graphs["port"].induced_subgraph(nodes)
        for g, w in zip(got, graphs["jax"].induced_subgraph(nodes)):
            np.testing.assert_array_equal(g, w)
        # the numpy route extracts the same edges in the same order
        for g, w in zip(got, graphs["kg"].induced_subgraph(nodes)):
            np.testing.assert_array_equal(g, w)
    big = np.concatenate(graphs["nodes"][:40])
    src, _, _ = graphs["port"].induced_subgraph(np.unique(big), max_edges=7)
    assert len(src) == 7


@pytest.mark.parametrize("p,seeds", [(0.0, (0,)), (0.1, (0, 1, 12345, 2**63 + 5))])
def test_pack_batch_matches_jax(graphs, p, seeds):
    lists = graphs["nodes"][:96]
    for seed in seeds:
        for ln, epg in ((16, 32), (128, 1024), (512, 8192)):
            got = graphs["port"].pack_batch(lists, ln=ln, epg=epg, dropout_p=p, seed=seed)
            want = graphs["jax"].pack_batch(lists, ln=ln, epg=epg, dropout_p=p, seed=seed)
            # the port's packer also returns each graph's real edges, clean and kept
            real = {k: (want[w].reshape(len(lists), epg) > 0).sum(axis=1).astype(np.int32)
                    for k, w in (("ne", "edge_weight"), ("ne_aug", "edge_weight_aug"))}
            _equal(got, dict(want, **real))
            if p == 0:
                assert got["edge_src_aug"] is got["edge_src"]
                assert got["ne_aug"] is got["ne"]
            else:
                assert got["edge_weight_aug"].sum() < got["edge_weight"].sum()
    # the count of graphs whose edges were cut
    cut = graphs["port"].pack_batch(lists, ln=16, epg=4)["truncated"]
    assert cut == graphs["jax"].pack_batch(lists, ln=16, epg=4)["truncated"] > 0


def test_pack_threads_do_not_change_the_batch(graphs, monkeypatch):
    """The packer splits 256 graphs over its threads (64 at least each); the
    dropout bits are drawn per graph, so any thread count packs alike."""
    lists = [graphs["nodes"][i % 300] for i in range(256)]
    runs = []
    for threads in ("1", "4"):
        monkeypatch.setenv("MEDTOK_PACK_THREADS", threads)
        plain = graphs["port"].pack_batch(lists, ln=128, epg=1024, dropout_p=0.1, seed=9)
        packed, _ = graphs["port"].pack_batch_stream_idx(
            graphs["arena"], graphs["off"], np.arange(256) % 300, ln=128, epg=1024,
            dropout_p=0.1, seed=9, want_aug=True)
        runs.append((plain, {k: None if v is None else np.array(v)
                             for k, v in packed.items()}))
    for a, b in zip(*runs):
        _equal(a, b)


@pytest.mark.parametrize("ln,epg", [(16, 32), (64, 256), (512, 8192)])
@pytest.mark.parametrize("want_aug", [False, True])
def test_compact_packs_match_jax(graphs, ln, epg, want_aug):
    """Each encoding: uint16 (src << 8) | dst at Ln <= 256, int32
    (src << 16) | dst above, from node lists and from the arena."""
    lists, idx = graphs["nodes"][:80], np.arange(100, 180)
    kw = dict(ln=ln, epg=epg, dropout_p=0.1, seed=77, want_aug=want_aug)
    got, _ = graphs["port"].pack_batch_compact(lists, **kw)
    want, _ = graphs["jax"].pack_batch_compact(lists, **kw)
    _equal(got, want)
    assert got["edge_packed"].dtype == (np.uint16 if ln <= 256 else np.int32)
    got, _ = graphs["port"].pack_batch_compact_idx(graphs["arena"], graphs["off"], idx, **kw)
    want, _ = graphs["jax"].pack_batch_compact_idx(graphs["arena"], graphs["off"], idx, **kw)
    _equal(got, want)


@pytest.mark.parametrize("want_aug", [False, True])
def test_stream_pack_matches_jax(graphs, want_aug):
    idx = np.array([3, 250, 17, 299, 3, 150, 64, 200])
    for ln, epg in ((128, 1024), (512, 8192), (16, 16)):
        kw = dict(ln=ln, epg=epg, dropout_p=0.3, seed=4, want_aug=want_aug)
        got, _ = graphs["port"].pack_batch_stream_idx(graphs["arena"], graphs["off"], idx, **kw)
        want, _ = graphs["jax"].pack_batch_stream_idx(graphs["arena"], graphs["off"], idx, **kw)
        _equal(got, want)
    assert got["truncated"] == want["truncated"] > 0
    with pytest.raises(ValueError):
        graphs["port"].pack_batch_stream_idx(graphs["arena"], graphs["off"], idx,
                                             ln=16, epg=70_000)
    with pytest.raises(TypeError):
        graphs["port"].pack_batch_stream_idx(graphs["arena"].astype(np.int64),
                                             graphs["off"], idx, ln=16, epg=16)


def test_arena_packers_check_rows_against_the_arena(graphs):
    """The C++ reads the arena offsets unchecked, so rows and arrays are
    checked before the call."""
    arena, off = graphs["arena"], graphs["off"]
    for bad in ([0, 300], [-1]):
        with pytest.raises(IndexError):
            graphs["port"].pack_batch_compact_idx(arena, off, bad, ln=16, epg=16)
        with pytest.raises(IndexError):
            graphs["port"].pack_batch_stream_idx(arena, off, bad, ln=128, epg=16)
    with pytest.raises(IndexError):
        graphs["port"].count_edges(arena, off, 0, 301, ln=16)
    with pytest.raises(TypeError):
        graphs["port"].count_edges(arena, off.astype(np.int32), 0, 4, ln=16)
    assert graphs["port"].count_edges(arena, off, 5, 5, ln=16).shape == (0,)


def test_count_edges_matches_jax(graphs):
    for ln in (16, 128, 512):
        got = graphs["port"].count_edges(graphs["arena"], graphs["off"], 10, 290, ln=ln)
        want = graphs["jax"].count_edges(graphs["arena"], graphs["off"], 10, 290, ln=ln)
        np.testing.assert_array_equal(got, want)
    # the count at a cap is what a pack at that cap emits before it cuts
    packed = graphs["port"].pack_batch(graphs["nodes"][10:20], ln=16, epg=1 << 14)
    np.testing.assert_array_equal(
        packed["edge_weight"].reshape(10, -1).sum(1),
        graphs["port"].count_edges(graphs["arena"], graphs["off"], 10, 20, ln=16))


class _Fence:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_pool_recycles_entries_after_their_fence(graphs, monkeypatch):
    g = NativeGraph(graphs["kg"].edge_src, graphs["kg"].edge_dst, graphs["kg"].rel_index,
                    graphs["kg"].num_nodes)
    idx = np.arange(8)
    kw = dict(ln=16, epg=32)
    # small entries: depth min(max(4, 32 MB / entry), cap)
    monkeypatch.setenv("MEDTOK_POOL_DEPTH_CAP", "3")
    entries = [g.pack_batch_compact_idx(graphs["arena"], graphs["off"], idx, **kw)[1]
               for _ in range(3)]
    assert len({id(e) for e in entries}) == 3
    fence = _Fence()
    entries[0].fence = fence
    out, again = g.pack_batch_compact_idx(graphs["arena"], graphs["off"], idx + 8, **kw)
    assert again is entries[0] and fence.waited == 1 and again.fence is None
    want, _ = graphs["jax"].pack_batch_compact_idx(graphs["arena"], graphs["off"], idx + 8,
                                                   **kw)
    _equal(out, want)
    # the returned arrays are the entry's buffers: numpy views of its tensors
    assert np.shares_memory(out["edge_packed"], again.tensors["edge_packed"].numpy())
    assert again.tensors["edge_packed"].dtype == torch.int16
    assert not again.tensors["node_ids"].is_pinned()
    # the default cap (32) with a big entry keeps POOL_DEPTH
    monkeypatch.delenv("MEDTOK_POOL_DEPTH_CAP")
    g.pack_batch_stream_idx(graphs["arena"], graphs["off"], np.arange(600) % 300, ln=512,
                            epg=8192)
    assert len(g._pools[(600, 512, 8192, False, "stream", False)]) == NativeGraph.POOL_DEPTH
    # a small entry's pool is deeper (up to 32 MB), capped at 32 entries
    g.pack_batch_compact_idx(graphs["arena"], graphs["off"], idx, ln=16, epg=64)
    assert len(g._pools[(8, 16, 64, False, True, False)]) == 32
    assert g.pool_bytes(pinned=True) == 0 and g.pool_bytes() == g.pool_bytes(pinned=False) > 0


def test_cpu_fence_holds_nothing(graphs):
    _, entry = graphs["port"].pack_batch_compact_idx(graphs["arena"], graphs["off"],
                                                     np.arange(4), ln=16, epg=32)
    entry.set_fence("cpu")
    assert entry.fence is None
    entry.set_fence(None)
    assert entry.fence is None
    before = counters().get("native.fence_wait_s", 0)
    entry.wait()
    assert counters().get("native.fence_wait_s", 0) == before
