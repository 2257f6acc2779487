"""MedTok with the DeepSeek-V2 text encoder through the port's entry points,
against the plain reference MedTok (``portbench/reference/deepseek_v2.py``
over ``reference/medtok.py``'s tail) on seeded weights at a tiny size, in
fp32 on the CPU: a packed ``export_all_packed`` and the unpacked
``export_all`` (tokens, weights, embeddings, each code's text feature), the
``MedTok`` API, and one packed ``Trainer.fit`` step (its loss and clipped
gradient).

Tolerances: fp32 on both sides, sums in other orders, so tokens agree
exactly (token_gap 0) and weights, embeddings and losses to about 1e-6;
1e-4 holds that with room and fails any changed equation, and 1e-3 on the
worst gradient leaf (the leaves' norms span decades, so the smallest carry
the largest relative rounding)."""

import numpy as np
import pytest
import torch

from medtok_tpu_torch.api import MedTok
from medtok_tpu_torch.data.dataset import epoch_batches
from medtok_tpu_torch.export import export_all, export_all_packed
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.train.trainer import Trainer
from portbench.check import judge_export, leaf_gap
from portbench.reference.deepseek_v2 import MedTokDSV2, param_spec
from portbench.reference.medtok import ClippedAdam, Inputs, aug_seed, epoch_codes, train_loss
from tests.dsv2_tiny import corpus, dataset, medtok_config, model_config, weights

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    corp = corpus()
    cfg = medtok_config()
    w = weights(param_spec(model_config()["model"]), seed=11)
    model = MultimodalTokenizer(cfg.model)
    model.load_state_dict(w, strict=True)
    return corp, cfg, w, model.eval()


def judged(ref, corp, cfg, codes, arrays):
    batch = Inputs(corp, model_config()["data"], "cpu").batch(codes)
    return judge_export(ref, ref.eval_rows(batch), arrays["tokens_all"][codes],
                        arrays["weights_all"][codes], arrays["embeddings_all"][codes]), batch


def test_packed_and_unpacked_exports_match_the_reference(setup):
    corp, cfg, w, model = setup
    ds = dataset(corp, cfg)
    packed = export_all_packed(model, ds, device="cpu", row_len=64, num_rows=6)
    unpacked = export_all(model, ds, batch_size=32, device="cpu")
    ref = MedTokDSV2(model_config()["model"], w)
    codes = np.arange(len(ds))
    for arrays in (packed, unpacked):
        got, _ = judged(ref, corp, cfg, codes, arrays)
        assert got["token_gap"] == 0.0, got
        assert got["weight_err"] < TOL and got["embedding_err"] < TOL, got
    np.testing.assert_array_equal(packed["tokens_all"], unpacked["tokens_all"])


def test_text_feature_is_the_last_tokens_state(setup):
    """The packed export's text rows: each code's feature is the reference
    encoder's state of its last token (``MedTokDSV2.pooled_text``)."""
    corp, cfg, w, model = setup
    ds = dataset(corp, cfg, native=False)
    ref = MedTokDSV2(model_config()["model"], w)
    codes = np.arange(24)
    batch = Inputs(corp, model_config()["data"], "cpu").batch(codes)
    want = ref.pooled_text(batch.input_ids, batch.text_mask)
    cdb = ds.make_batch(codes.tolist())
    with torch.no_grad():
        got = model.text_states(torch.from_numpy(cdb.input_ids),
                                torch.from_numpy(cdb.attention_mask))[:, 0]
    rel = torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)
    assert float(rel.max()) < TOL


def test_api_tokenizes_as_the_export(setup):
    corp, cfg, _, model = setup
    ds = dataset(corp, cfg)
    tok = MedTok(cfg, model, ds, device="cpu")
    out = tok.tokenize_batch(ds.med_codes[:8])
    arrays = export_all(model, ds, batch_size=8, device="cpu")
    np.testing.assert_array_equal(out.tokens, arrays["tokens_all"][:8])
    np.testing.assert_array_equal(tok.tokenize(ds.med_codes[3]), arrays["tokens_all"][3])


def test_one_packed_training_step_matches_the_reference(setup):
    """Trainer.fit's first packed step (frozen encoder, forward only) against
    the reference's loss and clipped gradient from the same weights, batch,
    edge dropout and dropout generator."""
    corp, _, w, _ = setup
    tr = dict(global_batch_size=16, packed_text=True, packed_row_len=64, lr=1e-3,
              beta1=0.9, beta2=0.95, max_grad_norm=1.0, shared_loss_beta=0.1,
              specific_loss_lamb=0.1)
    cfg = medtok_config(**tr)
    ds = dataset(corp, cfg)
    losses = []
    trainer = Trainer(cfg, device="cpu", log_fn=lambda s, m: losses.append(m["loss"]))
    state = trainer.init_state()
    trainer.model.load_state_dict(w, strict=True)
    order_seed, gen_seed = 5, 9
    state.generator.manual_seed(gen_seed)
    names = [n for n, _ in trainer.model.named_parameters() if not n.startswith("text_model.")]
    state = trainer.fit(state, epoch_batches(ds, batch_size=16, seed=order_seed), max_steps=1)
    grad = {n: m / (1 - 0.9) for n, m in zip(names, state.opt_state.mu)}

    params = {n: w[n].clone().requires_grad_(True) for n in names}
    ref = MedTokDSV2(model_config()["model"], {**w, **params})
    batch = Inputs(corp, model_config()["data"], "cpu").batch(
        epoch_codes(len(corp), order_seed, 0, 16, 0), aug_seed=aug_seed(order_seed, 0, 0))
    loss, _ = train_loss(ref, batch, torch.Generator().manual_seed(gen_seed), tr)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    clipped = ClippedAdam(params, tr).clip({n: torch.zeros_like(p) if g is None else g
                                            for (n, p), g in zip(params.items(), grads)})
    loss = float(loss.detach())
    assert abs(losses[0] - loss) / abs(loss) < TOL
    assert leaf_gap(grad, clipped) < 1e-3
    # the frozen encoder took no step
    for n, p in trainer.model.text_model.named_parameters():
        assert torch.equal(p, w["text_model." + n]), n
