"""The port's CUDA kernels against their plain PyTorch versions on the card,
in bf16: max|diff| / max|ref| <= 3e-2 (the on-card tolerance of the JAX
package's tools/onchip_parity.py) and every element within km.ULP_TOL bf16
ulps, since both versions round at the same points. Marked `cuda`: they
skip without a GPU.
This file imports no JAX, so on a machine with the card but without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

TOL = 3e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _agrees(out, ref, x=None, scale=None):
    return _rel(out, ref) <= TOL and km.bf16_ulp_error(out, ref, x, scale) <= km.ULP_TOL


def _branch_max(dw, folded, tier="default"):
    """max|bf16(o)|, K1's output at x = 0: the scale floor of its check."""
    zero = torch.zeros_like(dw)
    return km.ln_mlp_residual_plain(dw, zero, folded, None, tier).float().abs().max().item()


def _folded(c, dev, g):
    def r(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=g)
    return km.fold_block_mlp(1 + r(c, s=0.1), r(c, s=0.1), r(4 * c, c, s=c ** -0.5),
                             r(4 * c, s=0.05), r(c, 4 * c, s=(4 * c) ** -0.5),
                             r(c, s=0.05), 0.1 + 0.9 * torch.rand(c, device=dev, generator=g),
                             torch.bfloat16)


@pytest.mark.parametrize("tier", ["default", "hp"])
@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("c", [96, 128, 192, 384, 768])  # 128: run-time width
def test_k1_matches_plain(dev, c, post_ln, tier):
    g = torch.Generator(device=dev).manual_seed(c)
    rows = 1037  # ragged against every row tile
    dw = (2 * torch.randn(rows, c, device=dev, generator=g)).to(torch.bfloat16)
    x = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
    folded = _folded(c, dev, g)
    post = None
    if post_ln:
        post = ((1 + 0.1 * torch.randn(c, device=dev, generator=g)).float(),
                (0.1 * torch.randn(c, device=dev, generator=g)).float())
    before = km.ln_mlp_residual.launches
    out = km.ln_mlp_residual(dw, x, folded, post, tier)
    torch.cuda.synchronize()
    assert km.ln_mlp_residual.launches == before + 1
    ref = km.ln_mlp_residual_plain(dw, x, folded, post, tier)
    if post_ln:
        assert _agrees(out, ref, None, ref.float().abs().max().item())
    else:
        assert _agrees(out, ref, x, _branch_max(dw, folded, tier))


@pytest.mark.parametrize("c", [96, 192, 384, 768])
def test_k1_mlp_branch_alone_matches_plain(dev, c):
    """x = 0: the output is bf16(o), so the MLP is the whole signal."""
    g = torch.Generator(device=dev).manual_seed(100 + c)
    dw = (2 * torch.randn(517, c, device=dev, generator=g)).to(torch.bfloat16)
    zero = torch.zeros_like(dw)
    folded = _folded(c, dev, g)
    out = km.ln_mlp_residual(dw, zero, folded)
    ref = km.ln_mlp_residual_plain(dw, zero, folded)
    o_max = ref.float().abs().max().item()
    assert _agrees(out, ref, zero, o_max)
    # and the check refuses a K1 that drops the fc2 bias
    dropped = folded._replace(b2g=torch.zeros_like(folded.b2g))
    assert not _agrees(km.ln_mlp_residual(dw, zero, dropped), ref, zero, o_max)


def test_k2_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (3 * torch.randn(2, 37, 29, 96, device=dev, generator=g)).to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(96, device=dev, generator=g)).float()
    b = (0.1 * torch.randn(96, device=dev, generator=g)).float()
    out = km.layer_norm_rows(x, s, b)
    torch.cuda.synchronize()
    assert out.shape == x.shape
    assert _agrees(out, km.layer_norm_rows_plain(x, s, b))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    folded = _folded(96, dev, g)
    x = torch.randn(64, 96, device=dev, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        km.ln_mlp_residual(x.float(), x.float(), folded)
    with pytest.raises(ValueError, match="contiguous"):
        km.ln_mlp_residual(x.t().contiguous().t(), x, folded)
    with pytest.raises(ValueError, match="multiple of 32"):
        km.layer_norm_rows(x[:, :48].contiguous(), folded.b2g[:48].contiguous(),
                           folded.b2g[:48].contiguous())
    with pytest.raises(ValueError, match="devices"):
        km.ln_mlp_residual(x, x.cpu(), folded)
