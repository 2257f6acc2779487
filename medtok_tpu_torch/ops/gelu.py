"""GELU for the BERT FFN (counterpart of ``medtok_tpu/ops/gelu.py``).

fp32 keeps the exact erf gelu. bf16 activations take the JAX package's
tanh-composed minimax fit, as plain torch math with the same coefficients
and thresholds, so the two frameworks round at the same places:

    gelu(x) = x * sigmoid(2 p(x)),  p = degree-11 fit of atanh(2 Phi(x) - 1)
    over [-8.6, 2.8]; x > 2.77 returns x, x < -7.76 returns 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Horner coefficients (lowest first) of the degree-11 fit.
_P_COEF = (
    -0.0002957637269433988,
    0.7984603321101655,
    0.0020689632319751267,
    0.03641572140447887,
    -0.0015558347387300137,
    -0.000591322353090317,
    0.00020868589366660118,
    7.070647809280037e-05,
    6.631853369528119e-06,
    -2.213750333938961e-08,
    -3.7270747091005305e-08,
    -1.600752329195683e-09,
)

_X_HI = 2.77
_X_LO = -7.76


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """Exact-class gelu at bf16 resolution; the polynomial and sigmoid run
    in fp32 and the result is cast back to ``x.dtype``."""
    xf = x.float()
    q = torch.full_like(xf, _P_COEF[-1])
    for c in _P_COEF[-2::-1]:
        q = q * xf + c
    y = xf * torch.sigmoid(2.0 * q)
    y = torch.where(xf > _X_HI, xf, y)
    y = torch.where(xf < _X_LO, torch.zeros_like(y), y)
    return y.to(x.dtype)


def bert_gelu(x: torch.Tensor) -> torch.Tensor:
    """The fit for bf16 activations, exact erf gelu otherwise."""
    if x.dtype == torch.bfloat16:
        return gelu_bf16(x)
    return F.gelu(x)
