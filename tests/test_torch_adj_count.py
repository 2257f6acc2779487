"""Port vs JAX: the dense-adjacency Count (plain version of kernels K5 and
K5-lane) against a numpy histogram and the JAX ``gcn_norm_adj``; the JAX
``scripts/bench_adj.py`` Pallas kernels in interpret mode and the port's
``scripts/bench_adj.py`` on the CPU."""

import functools
import json
import os
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from medtok_tpu.models.layers import gcn_norm_adj as jax_gcn_norm_adj
from medtok_tpu_torch.models.layers import gcn_norm_adj, gcn_normalize
from medtok_tpu_torch.ops.adj_count import adj_count, adj_count_onehot, adj_count_reference
from medtok_tpu_torch.scripts import bench_adj

REPO = Path(__file__).resolve().parent.parent


def _edges(rng, B: int, Ln: int, Epg: int, binary: bool):
    """Per-graph chunked edges with a zero-weight padded tail per graph."""
    src = rng.integers(0, Ln, (B, Epg)).astype(np.int32)
    dst = rng.integers(0, Ln, (B, Epg)).astype(np.int32)
    w = (np.ones((B, Epg)) if binary else rng.random((B, Epg))).astype(np.float32)
    w[:, 3 * Epg // 4:] = 0.0
    return src.reshape(-1), dst.reshape(-1), w.reshape(-1)


def _histogram(src, dst, w, B: int, Ln: int) -> np.ndarray:
    """numpy Count of the bf16-rounded weights, summed in float64."""
    w16 = torch.from_numpy(w).to(torch.bfloat16).double().numpy()
    count = np.zeros((B, Ln, Ln), np.float64)
    b = np.repeat(np.arange(B), src.shape[0] // B)
    np.add.at(count, (b, dst, src), w16)
    return count


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("B,Ln,Epg", [(4, 64, 256), (3, 16, 32)])
def test_count_matches_histogram_and_jax(binary, B, Ln, Epg):
    rng = np.random.default_rng(B * Ln + binary)
    src, dst, w = _edges(rng, B, Ln, Epg, binary)
    ts, td, tw = map(torch.from_numpy, (src, dst, w))
    count = adj_count_reference(ts, td, tw, B, Ln)
    truth = _histogram(src, dst, w, B, Ln)
    if binary:   # integer sums: exact
        np.testing.assert_array_equal(count.numpy(), truth.astype(np.float32))
    else:        # fp32 sums of a few bf16 values
        np.testing.assert_allclose(count.numpy(), truth, atol=1e-6 * truth.max(), rtol=0)
    # the normalized adjacency of this Count against the JAX function, whose
    # Count is the bf16 one-hot product (layers.py:245-252)
    want = np.asarray(jax_gcn_norm_adj(jnp.asarray(src), jnp.asarray(dst),
                                       jnp.asarray(w), B, Ln))
    got = gcn_normalize(count.clone()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    # the wrappers take the plain version on CPU tensors, launching nothing
    launches = (adj_count.launches, adj_count_onehot.launches)
    for fn in (adj_count, adj_count_onehot):
        assert torch.equal(fn(ts, td, tw, B, Ln), count)
    assert (adj_count.launches, adj_count_onehot.launches) == launches


def test_gcn_norm_adj_rounds_weights_like_jax():
    """Fractional weights: the JAX function rounds each weight to bf16 in
    its one-hot Count; the port's production path must too (it added the
    fp32 weights before, 1.04e-3 apart at B=4, Ln=64, E=256 per graph)."""
    rng = np.random.default_rng(0)
    B, Ln, Epg = 4, 64, 256
    src = rng.integers(0, Ln, B * Epg).astype(np.int32)
    dst = rng.integers(0, Ln, B * Epg).astype(np.int32)
    w = rng.random(B * Epg).astype(np.float32)
    want = np.asarray(jax_gcn_norm_adj(jnp.asarray(src), jnp.asarray(dst),
                                       jnp.asarray(w), B, Ln))
    got = gcn_norm_adj(*map(torch.from_numpy, (src, dst, w)), B, Ln).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_count_wrappers_reject_mixed_devices():
    src = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        adj_count(src.to("meta"), src.to("meta"), src.float().to("meta"), 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        adj_count_onehot(src, src.to("meta"), src.float(), 2, 4)


def test_jax_bench_adj_pallas_kernels_in_interpret_mode(monkeypatch, capsys):
    """The JAX script's two Pallas Count kernels, run in interpret mode
    (pallas_call patched; no file of the JAX package changes), agree with
    its numpy histogram; the port's script on the same arguments, on the
    CPU, agrees in every variant."""
    argv = ["--b", "8", "--ln", "16", "--epg", "64"]
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(sys, "argv", ["bench_adj.py", *argv, "--variants", "pallas,pallas_lane"])
    # keep the script's compilation-cache setting out of this process
    real_makedirs, real_update = os.makedirs, jax.config.update
    monkeypatch.setattr(os, "makedirs", lambda p, *a, **k: None if str(p) == "/tmp/jax_cache"
                        else real_makedirs(p, *a, **k))
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if name == "jax_compilation_cache_dir" else real_update(name, value))
    runpy.run_path(str(REPO / "scripts" / "bench_adj.py"), run_name="__main__")
    jax_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("pallas", "pallas_lane"):
        assert "error" not in jax_out[name], jax_out[name]
        assert jax_out[name]["max_err"] <= 1e-6

    port = bench_adj.main([*argv, "--device", "cpu"])
    assert port["shape"] == jax_out["shape"] and port["device"] == "cpu"
    for name in bench_adj.VARIANTS:
        assert "error" not in port[name], port[name]
        assert port[name]["max_err"] <= 1e-6 and port[name]["ms"] > 0


def test_bench_adj_draw_matches_jax_script():
    """The port's edges are the JAX script's draw, in the same order."""
    src, dst, w, ne = bench_adj.draw_edges(4, 16, 32)
    rng = np.random.default_rng(3)
    want_ne = rng.integers(16, 32, 4)
    np.testing.assert_array_equal(ne, want_ne)
    for b in range(4):
        np.testing.assert_array_equal(src[b, :ne[b]], rng.integers(0, 16, ne[b]))
        np.testing.assert_array_equal(dst[b, :ne[b]], rng.integers(0, 16, ne[b]))
        assert (w[b, :ne[b]] == 1).all() and (w[b, ne[b]:] == 0).all()
    truth = bench_adj.histogram(src, dst, ne, 16)
    assert truth.sum() == ne.sum()


@pytest.mark.parametrize("variant,patched", [("int8", "int8_count"),
                                             ("cuda_count", "adj_count"),
                                             ("cuda_onehot", "adj_count_onehot")])
def test_bench_adj_records_only_an_int8_refusal(monkeypatch, variant, patched):
    """A refused ``torch._int_mm`` becomes the int8 row's ``error``; a
    failing hand kernel raises out of ``main``."""
    def refuse(*args, **kwargs):
        raise RuntimeError("refused")

    monkeypatch.setattr(bench_adj, patched, refuse)
    argv = ["--b", "2", "--ln", "8", "--epg", "16", "--variants", variant, "--device", "cpu"]
    if variant == "int8":
        assert bench_adj.main(argv)["int8"] == {"error": "RuntimeError: refused"}
    else:
        with pytest.raises(RuntimeError, match="refused"):
            bench_adj.main(argv)


def test_timed_warms_up_then_takes_least_mean():
    """``timed`` makes one warm-up call, then ``trials`` timings of
    ``iters`` calls each, and returns the least per-call mean."""
    from medtok_tpu_torch.scripts import timed

    calls = []
    ms = timed(lambda: calls.append(1), 3, torch.device("cpu"), iters=4)
    assert len(calls) == 1 + 3 * 4 and 0 <= ms < 1e3
