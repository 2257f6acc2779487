"""Faults planted in the program's timed path, to show that the check sees
them: each is a context manager that patches the program while it is open.

- ``unchanged_state``: a training step that returns its state unchanged
  (the parameters and the optimizer's moments put back after the step);
- ``half_batch``: a training step over the first half of the batch alone,
  its losses the means over that half;
- ``altered_token``: every quantizer sweep's first token moved to the next
  codeword where it is produced (weights and embeddings left as computed).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged_state():
    import torch
    from medtok_tpu_torch.train import trainer

    make = trainer.make_train_step

    def make_train_step(cfg, model, dp=None):
        step = make(cfg, model, dp)

        def unchanged(state, batch, packed=None):
            params = [p.detach().clone() for p in model.parameters()]
            mu = [m.clone() for m in state.opt_state.mu]
            nu = [v.clone() for v in state.opt_state.nu]
            state, metrics = step(state, batch, packed)
            with torch.no_grad():
                for p, q in zip(model.parameters(), params):
                    p.copy_(q)
                for m, q in zip(state.opt_state.mu, mu):
                    m.copy_(q)
                for v, q in zip(state.opt_state.nu, nu):
                    v.copy_(q)
            return state, metrics

        return unchanged

    return _patched(trainer, "make_train_step", make_train_step)


def half_batch():
    from medtok_tpu_torch.train import trainer

    loss_fn = trainer._loss_fn

    def first_half(model, batch, cfg, *, packed=None, generator=None):
        B = batch.input_ids.shape[0]
        h = B // 2
        E = batch.edge_src.shape[0] // B * h
        half = batch._replace(
            input_ids=batch.input_ids[:h], attention_mask=batch.attention_mask[:h],
            node_ids=batch.node_ids[:h], node_mask=batch.node_mask[:h],
            edge_src=batch.edge_src[:E], edge_dst=batch.edge_dst[:E],
            edge_weight=batch.edge_weight[:E], edge_src_aug=batch.edge_src_aug[:E],
            edge_dst_aug=batch.edge_dst_aug[:E], edge_weight_aug=batch.edge_weight_aug[:E],
            code_indices=batch.code_indices[:h])
        if packed is not None:
            packed = packed._replace(gather_idx=packed.gather_idx[:h],
                                     text_mask=packed.text_mask[:h])
        return loss_fn(model, half, cfg, packed=packed, generator=generator)

    return _patched(trainer, "_loss_fn", first_half)


def altered_token():
    from medtok_tpu_torch.models import quantizer

    quantize = quantizer.SoftVQQuantizer._quantize

    def moved(self, z, region=None, *, train: bool = False):
        out = quantize(self, z, region, train=train)
        n = self._cb().shape[0] if region is None else self._cb().shape[0] // 3
        idx = out.indices.clone()
        idx[:, 0] = (idx[:, 0] + 1) % n
        return out._replace(indices=idx)

    return _patched(quantizer.SoftVQQuantizer, "_quantize", moved)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_token": altered_token}
