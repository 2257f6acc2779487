"""The port's data auxiliaries against the JAX package's on the CPU:

- ``HeteroKG.from_csv`` (the ``csv`` module, no pandas) equals the JAX
  reader's pandas result on a synthetic kg.csv and on one whose nodes
  first appear as y before x and change type between rows: node types,
  type-local indices, and the edge groups in order with their arrays;
  each package reads the other's ``.npz`` cache;
- ``synthetic_kg_csv`` writes the JAX file's bytes from one seed;
- ``synthetic_code_vocab`` writes the JAX rows as ``.jsonl`` and
  ``.parquet``;
- ``random_code_batch`` draws the JAX arrays.
"""

import json

import numpy as np
import pandas as pd
import pytest

from medtok_tpu.data import kg as jax_kg
from medtok_tpu.data import synthetic as jax_synth
from medtok_tpu_torch.data import synthetic
from medtok_tpu_torch.data.dataset import read_jsonl
from medtok_tpu_torch.data.kg import HeteroKG


def same_hetero(a, b) -> None:
    assert list(a.node_type.items()) == list(b.node_type.items())
    assert list(a.node_type_graph_index.items()) == list(b.node_type_graph_index.items())
    assert list(a.edge_groups) == list(b.edge_groups)
    for key in a.edge_groups:
        for x, y in zip(a.edge_groups[key], b.edge_groups[key]):
            assert x.dtype == y.dtype == np.int64
            np.testing.assert_array_equal(x, y)


TRICKY_CSV = """relation,x_index,x_type,y_index,y_type,display_relation
ppi,5,gene/protein,9,drug,ppi
target,7,disease,5,gene/protein,target
ppi,9,disease,3,"effect, phenotype",ppi
target,3,drug,7,disease,target
ppi,11,gene/protein,9,drug,ppi
"""


@pytest.mark.parametrize("which", ["synthetic", "tricky"])
def test_heterokg_equals_jax_and_caches_cross(tmp_path, which):
    path = tmp_path / "kg.csv"
    if which == "synthetic":
        synthetic.synthetic_kg_csv(path, np.random.default_rng(0), num_nodes=100, num_edges=500)
    else:
        path.write_text(TRICKY_CSV)
    want = jax_kg.HeteroKG.from_csv(path)
    got = HeteroKG.from_csv(tmp_path)              # the directory holding kg.csv
    same_hetero(got, want)
    if which == "tricky":
        # first appearance over all x rows, then the y rows: 9 is a disease
        assert list(got.node_type) == [5, 7, 9, 3, 11]
        assert got.node_type[9] == "disease" and got.get_type_graph_index(9) == 1
    assert got.num_edges() == want.num_edges()
    assert all(got.num_nodes(t) == want.num_nodes(t) for t in set(want.node_type.values()))
    # each package reads the other's cache (the file is not read again)
    HeteroKG.from_csv(path, cache_path=tmp_path / "port.npz")
    jax_kg.HeteroKG.from_csv(path, cache_path=tmp_path / "jax.npz")
    missing = tmp_path / "missing.csv"
    same_hetero(jax_kg.HeteroKG.from_csv(missing, cache_path=tmp_path / "port.npz"), want)
    same_hetero(HeteroKG.from_csv(missing, cache_path=tmp_path / "jax.npz"), want)


def test_synthetic_kg_csv_is_the_jax_file(tmp_path):
    jax_synth.synthetic_kg_csv(str(tmp_path / "jax.csv"), np.random.default_rng(3),
                               num_nodes=300, num_edges=700)
    synthetic.synthetic_kg_csv(tmp_path / "port.csv", np.random.default_rng(3),
                               num_nodes=300, num_edges=700)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_synthetic_code_vocab_rows(tmp_path):
    jax_synth.synthetic_code_vocab(str(tmp_path / "jax.parquet"), np.random.default_rng(4),
                                   num_codes=40, num_nodes=300)
    want = pd.read_parquet(tmp_path / "jax.parquet")
    rows = {c: [list(v) if c == "pkg_index_list" else v for v in want[c]] for c in want}
    for suffix in (".jsonl", ".parquet"):
        path = tmp_path / f"port{suffix}"
        synthetic.synthetic_code_vocab(path, np.random.default_rng(4), num_codes=40,
                                       num_nodes=300)
        if suffix == ".jsonl":
            got = read_jsonl(path)
            assert json.loads(path.read_text().splitlines()[0])["med_code"] == "C00000"
        else:
            df = pd.read_parquet(path)
            got = {c: [list(v) if c == "pkg_index_list" else v for v in df[c]] for c in df}
        assert got == rows
    with pytest.raises(ValueError, match="jsonl"):
        synthetic.synthetic_code_vocab(tmp_path / "codes.csv", np.random.default_rng(4))


@pytest.mark.parametrize("kw", [{}, {"batch": 5, "text_len": 12, "max_nodes": 4,
                                     "max_edges_per_graph": 9, "edge_dropout_p": 0.5}])
def test_random_code_batch_is_the_jax_batch(kw):
    want = jax_synth.random_code_batch(np.random.default_rng(5), **kw)
    got = synthetic.random_code_batch(np.random.default_rng(5), **kw)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert isinstance(a, np.ndarray) and a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
