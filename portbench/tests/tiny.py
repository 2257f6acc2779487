"""A cell's configuration and traffic at a size a CPU test holds: the same
files' keys, small widths and counts, fp32 compute."""

from __future__ import annotations

import copy
import json

from portbench.harness import ROOT, Cell, load_json


def config(graph: str = "GCN") -> dict:
    cfg = load_json(ROOT / "configs" / "medtok-gcn.json")
    m = cfg["model"]
    m["text"].update(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
                     intermediate_size=64, max_position_embeddings=128)
    m["graph"].update(model_name=graph, num_nodes=300, in_channels=8, hidden_channels=16,
                      out_channels=16, gat_num_heads=2)
    m["quantizer"].update(codebook_size=90, codebook_embed_dim=16, usage_buffer_size=4096)
    m["compute_dtype"] = "float32"
    cfg["data"].update(text_buckets=[8, 16, 32, 64], node_buckets=[4, 16, 32],
                       edge_buckets=[16, 64, 256])
    return cfg


def corpus(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec.update(codes=640, kg_nodes=300, extra_words=20)
    spec["nodes"].update(max_small=4, tiers=[[0.09, 5, 16], [0.03, 17, 32]])
    spec["kg"].update(edges=3000, local_window=8)
    return spec


def traffic(kind: str) -> dict:
    t = load_json(ROOT / "traffic" / f"{kind}.json")
    t["corpus"] = corpus(t["corpus"])
    if kind == "export":
        t.update(codes_per_call=128, packed_rows=[8, 64], warmup_calls=1, trace_calls=2,
                 check_codes=64)
    else:
        t["train"].update(global_batch_size=32, packed_rows_per_shard=16)
        t.update(trace_steps=2)
    return t


def cell(name: str, limits: dict | None = None) -> Cell:
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    spec = {w["name"]: w for w in bench["workloads"]}[name]
    kind = spec["traffic"]
    graph = "GAT" if spec["config"].endswith("gat") else "GCN"
    return Cell(name, bench, config=config(graph), traffic=traffic(kind), limits=limits or {})
