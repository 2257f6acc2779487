"""The yardstick's arithmetic: the kernel bounds of the project's kernel
table, and model operations counted from true sizes only."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import counts
from portbench.datagen import make_corpus
from portbench.harness import ROOT, load_json
from portbench.reference.medtok import Inputs
from portbench.tests import tiny


def test_k1_bound_of_the_export_sweep():
    # z [4096, 64] x e [21000, 64], k 5: 3 x 11.01 GFLOP at 495 TFLOP/s
    assert counts.k1_bound_s(4096, 21000, 64, 5) * 1e3 == pytest.approx(0.0667, abs=5e-5)


def test_k2_bound_of_the_export_packing():
    # [256, 12, 128, 64] bf16: 196.4 MB of bytes (PERF.md's kernel table),
    # which the first export group's 31,671 tokens give
    seg = np.zeros((256, 128), np.int32)
    flat = seg.reshape(-1)
    at, code = 0, 1
    while at < 31_671:
        n = min(17, 31_671 - at)
        row, col = divmod(at, 128)
        n = min(n, 128 - col)
        flat[at:at + n] = code
        at, code = at + n, code + 1
    assert counts.k2_bound_s(seg, 12, 64) * 1e3 == pytest.approx(0.0586, abs=5e-5)


def test_k2_counts_pairs_within_segments_only():
    one = np.zeros((1, 128), np.int32)
    one[0, :64] = 1
    two = np.zeros((1, 128), np.int32)
    two[0, :32], two[0, 32:64] = 1, 2
    # the same tokens in two segments: half the pairs, the same bytes
    assert counts.k2_bound_s(two, 12, 64) <= counts.k2_bound_s(one, 12, 64)


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_add_over_codes(train):
    cfg = load_json(ROOT / "configs" / "medtok-gcn.json")["model"]
    t, n, e = np.array([5, 17, 64]), np.array([1, 20, 512]), np.array([0, 30, 8192])
    whole = counts.model_flops(cfg, t, n, e, train=train)
    parts = sum(counts.model_flops(cfg, t[i:i + 1], n[i:i + 1], e[i:i + 1], train=train)
                for i in range(3))
    assert whole == pytest.approx(parts)


def test_model_flops_of_one_code_is_mostly_bert():
    cfg = load_json(ROOT / "configs" / "medtok-gcn.json")["model"]
    bert = 12 * (2 * 17 * (4 * 768 ** 2 + 2 * 768 * 3072) + 4 * 17 ** 2 * 768)
    got = counts.model_flops(cfg, [17], [20], [161], train=False)
    assert bert < got < 1.01 * bert


def test_padding_adds_no_operations():
    """The sizes counted are the codes' own: the same code counts the same
    whatever batch (and so whatever bucket) it is padded into."""
    corpus = make_corpus(dict(tiny.traffic("export")["corpus"], seed=3))
    inputs = Inputs(corpus, tiny.config()["data"], "cpu")
    cfg = tiny.config()["model"]
    short = int(np.argmin([len(d.split()) for d in corpus.descs]))
    long_ = int(np.argmax([len(d.split()) for d in corpus.descs]))
    alone = inputs.sizes([short])
    beside = inputs.sizes([short, long_])
    assert [a[0] for a in alone] == [b[0] for b in beside]
    assert inputs.batch([short, long_]).input_ids.shape[1] > alone[0][0]
    assert counts.model_flops(cfg, *alone, train=False) < counts.model_flops(
        cfg, *beside, train=False)
