"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an sm_90 GPU and ``nvcc``; elsewhere every test here skips (decided
inside the fixture, never at import). Run on the H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 max abs err 1e-4 (f32 sums in another order); bf16 outputs
compared in f32 with atol/rtol 2e-2 (one bf16 rounding of the output, and
of the softmax weights, on each side). Each bf16 body (tensor-core K1 for
D % 16 == 0 and D <= 128, FMA K1 otherwise, K2) is also held against
``ref.tiled_softmax_attention`` on inputs whose q.k sums are exact in f32:
within half a bf16 ulp (2^-8 relative) plus 1e-5.
"""
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import (_plain_decode,
                                                  decode_attention)
from repro_torch.kernels.flash_attention import _plain_dense, flash_attention
from repro_torch.kernels.ref import tiled_softmax_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    from repro_torch.kernels.build import find_nvcc
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, exp, dtype):
    if dtype == torch.float32:
        assert (got - exp).abs().max().item() <= 1e-4
    else:
        torch.testing.assert_close(got.float(), exp.float(), atol=2e-2,
                                   rtol=2e-2)


def _exact_qk(g, shape, dev):
    """bf16 values n / 8, |n| <= 16: q.k sums are exact in f32."""
    return torch.randint(-16, 17, shape, generator=g,
                         device=dev).bfloat16() / 8


def _check_order(got, exp):
    """bf16 output within half an ulp of the kernel-order reference."""
    assert ((got.float() - exp).abs() - 2.0 ** -8 * exp.abs()).max() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,d,window", [
    (2, 268, 8, 8, 128, None),     # ragged prefill, MHA
    (2, 100, 8, 2, 64, None),      # GQA
    (1, 77, 4, 1, 64, 16),         # MQA + window
    (3, 13, 4, 4, 256, None),      # the service's short prompt, wide head
    (1, 40, 2, 2, 8, 5),           # narrowest head
])
def test_flash_kernel_matches_plain(dev, dtype, b, t, h, kv, d, window):
    g = torch.Generator(device=dev).manual_seed(t + h)
    q = torch.randn(b, t, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, t, kv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, t, kv, d, generator=g, device=dev).to(dtype)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    exp, exp_lse = _plain_dense(q, k, v, window=window, return_lse=True)
    _check(out, exp, dtype)
    assert (lse - exp_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d", [
    (8, 275, 8, 8, 128),
    (2, 200, 8, 2, 64),
    (3, 20, 4, 1, 64),
    (1, 33, 32, 4, 256),
])
def test_decode_kernel_matches_plain(dev, dtype, b, s, h, kv, d):
    g = torch.Generator(device=dev).manual_seed(s + h)
    q = torch.randn(b, 1, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
    valid = torch.rand(b, s, generator=g, device=dev) > 0.4
    valid[:, 0] = True
    n0 = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    _check(out, _plain_decode(q, k, v, valid), dtype)


@pytest.mark.parametrize("b,t,h,kv,d,window", [
    (2, 268, 8, 8, 128, None),     # tensor-core body, ragged prefill
    (2, 100, 8, 2, 64, 16),        # tensor-core body, GQA + window
    (3, 13, 4, 4, 256, None),      # FMA body, wide head
    (1, 40, 2, 2, 8, 5),           # FMA body, narrowest head
])
def test_flash_bf16_bodies_match_kernel_order(dev, b, t, h, kv, d, window):
    g = torch.Generator(device=dev).manual_seed(t + d)
    q = _exact_qk(g, (b, t, h, d), dev)
    k = _exact_qk(g, (b, t, kv, d), dev)
    v = torch.randn(b, t, kv, d, generator=g, device=dev).bfloat16()
    pos = torch.arange(t, device=dev)
    ok = pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= (pos[:, None] - pos[None, :]) < window
    out = flash_attention(q, k, v, window=window)
    exp, _ = tiled_softmax_attention(q, k, v, ok[None, None])
    _check_order(out, exp)


@pytest.mark.parametrize("b,s,h,kv,d", [(8, 275, 8, 8, 128),
                                        (1, 33, 32, 4, 256)])
def test_decode_bf16_body_matches_kernel_order(dev, b, s, h, kv, d):
    g = torch.Generator(device=dev).manual_seed(s + d)
    q = _exact_qk(g, (b, 1, h, d), dev)
    k = _exact_qk(g, (b, s, kv, d), dev)
    v = torch.randn(b, s, kv, d, generator=g, device=dev).bfloat16()
    valid = torch.rand(b, s, generator=g, device=dev) > 0.4
    valid[:, 0] = True
    exp, _ = tiled_softmax_attention(q, k, v, valid[:, None, None, :])
    _check_order(decode_attention(q, k, v, valid), exp)


def test_dispatch_routes_cuda_tensors_to_the_kernels(dev):
    q = torch.randn(1, 16, 2, 64, device=dev)
    n0 = flash_attention.launches
    dispatch.dense_attention(q, q, q)
    assert flash_attention.launches == n0 + 1
    with dispatch.forced("torch"):
        dispatch.dense_attention(q, q, q)
    assert flash_attention.launches == n0 + 1


def test_kernel_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 16, 2, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="valid"):
        decode_attention(q[:, :1].contiguous(), q, q,
                         torch.ones(1, 16, device=dev))

