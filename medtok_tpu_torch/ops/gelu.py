"""GELU for the BERT FFN (counterpart of ``medtok_tpu/ops/gelu.py``).

fp32 keeps the exact erf gelu. bf16 activations take the JAX package's
tanh-composed minimax fit, with the same coefficients and thresholds, so the
two frameworks round at the same places:

    gelu(x) = x * sigmoid(2 p(x)),  p = degree-11 fit of atanh(2 Phi(x) - 1)
    over [-8.6, 2.8]; x > 2.77 returns x, x < -7.76 returns 0.

``gelu_bf16`` is the fit as plain torch math: the oracle, and the route of
CPU tensors. ``gelu_fit`` takes a bf16 CUDA tensor through one hand-written
kernel, ``csrc/gelu.cu``: one bf16 read and one bf16 write an element where
the plain version runs about 30 fp32 passes, rounded where the plain version
rounds, so the two agree bit for bit on the card. The kernel is forward only
(the BERT is frozen and runs without a gradient): ``gelu_fit`` raises where
autograd would need one. It counts its launches (``gelu_fit.launches``) and,
in the ``utils/profiling`` registry, the elements of every bf16 call
(``gelu.elems``) and of those the kernel took (``gelu.kernel_elems``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from medtok_tpu_torch.ops import _build
from medtok_tpu_torch.utils.profiling import count

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

# the coefficients as the kernel reads them: fp32, rounded to nearest as
# torch rounds a Python scalar into an fp32 op
_KERNEL_COEF = (ctypes.c_float * len(_P_COEF))(*_P_COEF)


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


def _launch_args(x: torch.Tensor, out: torch.Tensor, stream: int) -> tuple:
    """The arguments of ``medtok_gelu_fit``: x, out, numel, the
    coefficients, x_hi, x_lo, stream."""
    return (x.data_ptr(), out.data_ptr(), x.numel(), ctypes.addressof(_KERNEL_COEF),
            _X_HI, _X_LO, stream)


def gelu_fit(x: torch.Tensor) -> torch.Tensor:
    """The fit of a bf16 tensor, as a new tensor: the plain version on the
    CPU, the kernel on CUDA (raising on anything it does not take)."""
    count("gelu.elems", x.numel())
    if x.device.type == "cpu":
        return gelu_bf16(x)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("gelu_fit takes a contiguous bf16 CUDA tensor (or a CPU "
                         f"tensor), got {x.dtype} {x.device} {tuple(x.stride())}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the gelu kernel is forward only: run it under "
                           "torch.no_grad() or on a tensor that needs no gradient")
    out = torch.empty_like(x)
    if x.numel():
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            code = lib.medtok_gelu_fit(
                *_launch_args(x, out, torch.cuda.current_stream(x.device).cuda_stream))
        _build.check(code, "medtok_gelu_fit")
        gelu_fit.launches += 1
    count("gelu.kernel_elems", x.numel())
    return out


#: launches of the CUDA kernel (CPU calls of the plain version do not count)
gelu_fit.launches = 0


def bert_gelu(x: torch.Tensor) -> torch.Tensor:
    """The fit for bf16 activations, exact erf gelu otherwise."""
    if x.dtype == torch.bfloat16:
        return gelu_fit(x)
    return F.gelu(x)
