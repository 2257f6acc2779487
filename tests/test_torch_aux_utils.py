"""The port's utility auxiliaries against the JAX package's on the CPU:

- ``utils/zero.py``: ``create_zero_config`` for every stage x precision,
  ``dp_shard_spec`` against JAX's ``PartitionSpec``, ``zero_plan`` leaf by
  leaf against JAX's on a small model's parameters and Adam state, and a
  stage-3 Adam step on two gloo ranks against the replicated step;
- ``utils/image.py::center_crop_arr`` within 1e-4 (float) and one level
  (uint8) of JAX's, on ``tests/test_vestiges.py``'s shapes and odd ones;
- ``ops/drop_path.py``: identities, the mask's shape, the exact scale and
  JAX's errors;
- ``utils/profiling.py``: ``StepTimer.summary()``'s keys and a trace file
  holding an ``annotate`` range; ``utils/platform.py::tune_malloc``.
"""

import itertools
import json

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec

from medtok_tpu.ops import drop_path as jax_drop_path
from medtok_tpu.parallel.mesh import DP_AXIS, make_mesh
from medtok_tpu.utils import image as jax_image
from medtok_tpu.utils import platform as jax_platform
from medtok_tpu.utils import profiling as jax_profiling
from medtok_tpu.utils import zero as jax_zero
from medtok_tpu_torch.config import (
    GraphEncoderConfig,
    ModelConfig,
    QuantizerConfig,
    TextEncoderConfig,
)
from medtok_tpu_torch.ops.drop_path import DropPath, drop_path
from medtok_tpu_torch.parallel.mesh import DataParallel
from medtok_tpu_torch.utils import image, platform, profiling, zero
from tests.torch_dp_ranks import spawn_ranks


@pytest.mark.parametrize("stage,precision", itertools.product(range(4), ("bf16", "fp32",
                                                                          "none")))
def test_create_zero_config_equals_jax(stage, precision):
    for kw in ({}, {"clip_grad": 1.0, "weight_decay": 0.01, "lr": 3e-4,
                    "gradient_accumulation_steps": 4, "beta2": 0.95}):
        kw = dict(global_batch_size=256, mixed_precision=precision, zero_stage=stage, **kw)
        assert zero.create_zero_config(**kw) == jax_zero.create_zero_config(**kw)


def test_create_zero_config_errors_as_jax():
    for kw in ({"mixed_precision": "fp16"}, {"zero_stage": 4}):
        with pytest.raises(ValueError, match="fp16" if "mixed_precision" in kw else "0..3"):
            zero.create_zero_config(global_batch_size=8, **kw)
        with pytest.raises(ValueError):
            jax_zero.create_zero_config(global_batch_size=8, **kw)


def spec_dim(spec: PartitionSpec):
    dims = [d for d, a in enumerate(spec) if a == DP_AXIS]
    return dims[0] if dims else None


def test_dp_shard_spec_equals_jax():
    for shape in [(16, 64), (3, 5), (), (8,), (5,), (64, 64), (8, 3, 16), (768, 3072),
                  (21000, 64), (7, 24, 24)]:
        for n in (1, 2, 3, 8):
            assert zero.dp_shard_spec(shape, n) == spec_dim(jax_zero.dp_shard_spec(shape, n))


# the verify recipe's widths
SMALL = ModelConfig(
    text=TextEncoderConfig(vocab_size=200, hidden_size=32, num_layers=2, num_heads=4,
                           intermediate_size=64),
    graph=GraphEncoderConfig(num_nodes=300, in_channels=8, hidden_channels=16,
                             out_channels=16),
    quantizer=QuantizerConfig(codebook_size=90, codebook_embed_dim=16, usage_buffer_size=64),
    compute_dtype="float32")


def small_model_state():
    """A small tokenizer's state_dict and an Adam state after one step, as
    (name -> tensor, name -> {exp_avg, exp_avg_sq, step})."""
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

    torch.manual_seed(0)
    model = MultimodalTokenizer(SMALL)
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    names = {id(p): k for k, p in params.items()}
    state = {names[id(p)]: s for p, s in opt.state.items()}
    return {k: v.detach() for k, v in params.items()}, state


@pytest.mark.parametrize("n", [2, 8])
def test_zero_plan_equals_jax_leaf_by_leaf(n):
    params, opt_state = small_model_state()
    np_params = {k: v.numpy() for k, v in params.items()}
    mesh = make_mesh(dp=n, tp=1)
    jax_opt = optax.adam(1e-3).init(np_params)[0]          # ScaleByAdamState
    dp = DataParallel(0, n, torch.device("cpu"))
    for stage in range(4):
        got = zero.zero_plan(stage, dp, params, opt_state)
        want = jax_zero.zero_plan(stage, mesh, np_params, jax_opt)
        shard = []
        for name in params:
            pw = spec_dim(want["params"][name].spec)
            assert got["params"][name] == zero._placement(pw), (stage, name)
            for key, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                ow = spec_dim(getattr(want["opt_state"], field)[name].spec)
                assert got["opt_state"][name][key] == zero._placement(ow), (stage, name, key)
                shard.append(ow is not None)
            assert spec_dim(want["opt_state"].count.spec) is None
            assert got["opt_state"][name]["step"] == zero._placement(None)
        assert any(shard) == (stage >= 1)
    assert "opt_state" not in zero.zero_plan(1, dp, params)
    with pytest.raises(ValueError, match="0..3"):
        zero.zero_plan(4, dp, params)


def test_zero_stage3_step_on_two_gloo_ranks(tmp_path):
    """The JAX ZeRO test's tiny parameters and loss: one Adam step on
    stage-3 DTensors over two gloo ranks against the replicated step.
    (Gloo has no all-to-all; DTensor takes an all-gather and a slice for it
    on its own, so the step runs on gloo as it is.)"""
    rng = np.random.default_rng(0)
    spec = {"params": {"w": rng.normal(size=(32, 16)).astype(np.float32),
                       "b": np.zeros(16, np.float32), "odd": np.ones(5, np.float32)},
            "x": rng.normal(size=(64, 32)).astype(np.float32),
            "y": rng.normal(size=(64, 16)).astype(np.float32)}
    ranks = spawn_ranks("zero", 2, tmp_path, spec)
    for r in ranks:
        assert r["placements"] == {"w": "S(0)", "b": "S(0)", "odd": "R"}
        assert r["local_shapes"] == {"w": (16, 16), "b": (8,), "odd": (5,)}
        for k in spec["params"]:
            np.testing.assert_allclose(r["stage3"][k], r["replicated"][k], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(r["stage3"][k], ranks[0]["stage3"][k])
        assert np.abs(r["replicated"]["w"] - spec["params"]["w"]).max() > 1e-3


# tests/test_vestiges.py's shapes, then odd ones: an odd halving, an
# upsampling resize, an odd crop
CROP_CASES = [((277, 413, 3), 64), ((300, 500, 3), 64), ((256, 384), 64),
              ((256, 320, 3), 64), ((97, 131, 3), 40), ((51, 70), 64)]


@pytest.mark.parametrize("shape,size", CROP_CASES)
def test_center_crop_arr_matches_jax(shape, size):
    rng = np.random.default_rng(sum(shape))
    f = rng.random(shape, dtype=np.float32)
    u = rng.integers(0, 256, size=shape, dtype=np.uint8)
    got, want = image.center_crop_arr(f, size), jax_image.center_crop_arr(f, size)
    assert got.shape == want.shape == (size, size, *shape[2:]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got, want = image.center_crop_arr(u, size), jax_image.center_crop_arr(u, size)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_center_crop_arr_errors():
    for arr, size in ((np.zeros((8, 8)), 0), (np.zeros((2, 8, 8, 3)), 4)):
        with pytest.raises(ValueError):
            image.center_crop_arr(arr, size)
        with pytest.raises(ValueError):
            jax_image.center_crop_arr(arr, size)


def test_drop_path_identities_mask_scale_and_errors():
    x = torch.arange(24.0).reshape(4, 3, 2)
    assert drop_path(x, 0.0) is x
    assert drop_path(x, 0.7, deterministic=True) is x
    assert drop_path(x, 1.5, deterministic=True) is x      # JAX checks the range after
    for p in (1.0, -0.1, 1.5):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            drop_path(x, p)
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            jax_drop_path.drop_path(jax.random.PRNGKey(0), jax.numpy.asarray(x.numpy()), p)
    g = torch.Generator().manual_seed(0)
    y = torch.randn(512, 4, 3, generator=g, dtype=torch.bfloat16)
    for scale in (True, False):
        out = drop_path(y, 0.3, generator=torch.Generator().manual_seed(1), scale_by_keep=scale)
        kept = (out != 0).flatten(1).any(dim=1)
        assert not out[~kept].any()
        s = torch.ones((), dtype=torch.bfloat16) / torch.tensor(0.7, dtype=torch.bfloat16)
        assert torch.equal(out[kept], y[kept] * s if scale else y[kept])
        assert 0.6 < float(kept.float().mean()) < 0.8
    again = drop_path(y, 0.3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(again, drop_path(y, 0.3, generator=torch.Generator().manual_seed(1)))
    m = DropPath(0.5, generator=torch.Generator().manual_seed(2))
    assert m.eval()(y) is y and DropPath(0.0)(y) is y
    assert not torch.equal(m.train()(y), y)


def test_step_timer_and_trace(tmp_path):
    got, want = profiling.StepTimer(), jax_profiling.StepTimer()
    assert got.summary() == want.summary() == {} and got.steps_per_sec == 0.0
    for _ in range(3):
        got.start(sync_on=[torch.ones(2)])
        want.start()
        got.stop(sync_on={"a": torch.ones(2)})
        want.stop()
    assert list(got.summary()) == list(want.summary())
    assert all(v > 0 for v in got.summary().values())
    with profiling.trace(tmp_path / "prof") as prof:
        with profiling.annotate("medtok.aux.span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "medtok.aux.span" in names
    assert any(e.key == "medtok.aux.span" for e in prof.key_averages())


def test_tune_malloc_as_jax():
    assert platform.tune_malloc() == jax_platform.tune_malloc()
    assert platform.apply_platform_env() is None


def test_large_model_plan_shards_every_big_leaf():
    """At ModelConfig() width over 8 ranks, stage 3 shards every parameter
    of a million elements or more (none is indivisible by 8)."""
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

    model = MultimodalTokenizer(ModelConfig(), device="meta")
    params = dict(model.named_parameters())
    plan = zero.zero_plan(3, DataParallel(0, 8, torch.device("cpu")), params)["params"]
    big = [k for k, p in params.items() if p.numel() >= 1 << 20]
    assert big and all(plan[k] != zero._placement(None) for k in big)
