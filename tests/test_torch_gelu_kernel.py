"""The bf16 gelu fit's kernel (``csrc/gelu.cu``) and its wrapper
(``ops/gelu.py::gelu_fit``).

On the CPU: the wrapper takes the plain version (bit for bit) on bf16 and
exact erf on fp32, the C entry point is bound and defined, and the kernel
gets the plain version's coefficients and thresholds. The tests marked
``card`` hold the kernel bit for bit to the plain version on the card (every
bf16 pattern; the export's FFN shape aligned, unaligned and at an odd
numel) and skip without one. This file imports no JAX, so it runs on the
card as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_gelu_kernel.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from medtok_tpu_torch.ops import _build
from medtok_tpu_torch.ops import gelu as G
from medtok_tpu_torch.utils.profiling import counters

SOURCE = Path(G.__file__).resolve().parent.parent / "csrc" / "gelu.cu"
# the export's FFN activation: 256 packed rows of 128 tokens, 3072 wide
EXPORT_SHAPE = (256, 128, 3072)


def all_bf16() -> torch.Tensor:
    """Every bf16 bit pattern once (NaNs, infinities, subnormals, -0)."""
    return torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def test_cpu_bf16_is_the_plain_version_bit_for_bit():
    x = all_bf16()
    before = counters()
    launches = G.gelu_fit.launches
    for fn in (G.gelu_fit, G.bert_gelu):
        got = fn(x)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert torch.equal(bits(got), bits(G.gelu_bf16(x)))
    after = counters()
    assert after["gelu.elems"] - before.get("gelu.elems", 0) == 2 * x.numel()
    assert after.get("gelu.kernel_elems", 0) == before.get("gelu.kernel_elems", 0)
    assert G.gelu_fit.launches == launches


def test_fp32_is_exact_erf():
    x = torch.linspace(-9.0, 4.0, 4001)
    assert torch.equal(G.bert_gelu(x), F.gelu(x))


def test_entry_point_is_bound_and_defined():
    argtypes, restype = _build._SIGNATURES["medtok_gelu_fit"]
    assert restype is ctypes.c_int
    src = SOURCE.read_text()
    m = re.search(r'extern "C" int medtok_gelu_fit\(([^)]*)\)', src)
    assert m, "csrc/gelu.cu defines no medtok_gelu_fit"
    assert len(m.group(1).split(",")) == len(argtypes)
    # the source's coefficient count is the fit's degree + 1
    assert int(re.search(r"GELU_COEFS = (\d+);", src).group(1)) == len(G._P_COEF)
    assert SOURCE in _build._sources()


def test_kernel_gets_the_plain_versions_constants():
    x = torch.zeros(24, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    args = G._launch_args(x, out, 1234)
    argtypes = _build._SIGNATURES["medtok_gelu_fit"][0]
    assert len(args) == len(argtypes)
    ptr_x, ptr_y, n, coef, x_hi, x_lo, stream = args
    assert (ptr_x, ptr_y, n, stream) == (x.data_ptr(), out.data_ptr(), 24, 1234)
    got = ctypes.cast(coef, ctypes.POINTER(ctypes.c_float))[:len(G._P_COEF)]
    assert got == [float(np.float32(c)) for c in G._P_COEF]
    # each float as ctypes hands it to the C entry, and as torch rounds a
    # Python scalar into the plain version's fp32 compares
    for value, want in ((x_hi, G._X_HI), (x_lo, G._X_LO)):
        assert ctypes.c_float(value).value == float(np.float32(want))
        assert float(torch.tensor(want, dtype=torch.float32)) == float(np.float32(want))


def test_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="bf16 CUDA tensor"):
        G.gelu_fit(torch.empty(8, dtype=torch.bfloat16, device="meta"))


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def kernel_vs_plain(x: torch.Tensor) -> int:
    """Elements where the kernel's bits differ from the plain version's;
    the kernel writes a new tensor and leaves x as it was."""
    keep = x.clone()
    launches = G.gelu_fit.launches
    got = G.gelu_fit(x)
    assert G.gelu_fit.launches == launches + 1
    torch.cuda.synchronize()
    assert got.data_ptr() != x.data_ptr() and torch.equal(bits(x), bits(keep))
    return int((bits(got) != bits(G.gelu_bf16(x))).sum())


@pytest.mark.card
def test_card_every_bf16_pattern(cuda):
    assert kernel_vs_plain(all_bf16().to(cuda)) == 0


@pytest.mark.card
@pytest.mark.parametrize("layout", ["aligned", "unaligned", "odd numel"])
def test_card_export_shape(cuda, layout):
    gen = torch.Generator(device=cuda).manual_seed(28)
    n = int(np.prod(EXPORT_SHAPE))
    flat = (torch.randn(n + 8, generator=gen, device=cuda) * 3).to(torch.bfloat16)
    if layout == "aligned":
        x = flat[:n].view(EXPORT_SHAPE)
    elif layout == "unaligned":          # 2 bytes past a 16-byte boundary
        x = flat[1:n + 1].view(EXPORT_SHAPE)
        assert x.data_ptr() % 16 == 2
    else:
        x = flat[:n - 3069]
    assert kernel_vs_plain(x) == 0


@pytest.mark.card
def test_card_refuses_a_gradient(cuda):
    x = torch.randn(64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        G.gelu_fit(x)
    with torch.no_grad():
        assert torch.equal(bits(G.gelu_fit(x)), bits(G.gelu_bf16(x.detach())))
