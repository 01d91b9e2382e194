"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an sm_90 GPU and ``nvcc``; elsewhere every test here skips (decided
inside the fixture, never at import). Run on the H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 max abs err 1e-4 (f32 sums in another order); bf16 outputs
compared in f32 with atol/rtol 2e-2 (one bf16 rounding of the output, and
of the softmax weights, on each side). Each bf16 attention-forward body
(the Hopper K1 for D % 16 == 0 and D <= 128, in base 2; FMA K1 otherwise,
K2, with the split layout it runs) is also held against
``ref.tiled_softmax_attention`` on inputs whose q.k sums are exact in f32:
within half a bf16 ulp (2^-8 relative) plus 1e-5. K1 with its LSE, K2
and K3 rerun bit for bit. The training kernels (K3, K4) are f32 inside in
both their versions: f32 within 1e-4 of the largest value, bf16 within one
bf16 ulp (2^-7) of each value plus 1e-4 of the largest; K4's bf16
tensor-core body also against ``ref.tiled_policy_loss`` (its order of
arithmetic) on inputs with exact logits, its dh and dw within half a bf16
ulp plus 1e-5 of the largest, and reruns bit for bit. So are the SSD scan
kernels (K6, K7): their
f32 outputs (y, states, ddt, dA) are held within 1e-4 of the largest value
for f32 and bf16 inputs alike, their bf16 outputs (dx, dB, dC) within one
bf16 ulp of each value plus 1e-4 of the largest. So is K5, the GIPO loss
over given logits: its forward's loss and metrics within 1e-4 relative
(floored at 1), its d_logits as K3's and K4's outputs; its register body
also against ``ref.tiled_gipo_head_loss`` at the layout it reports (the
partial rows within 2e-6 of each column's largest value, d_logits within
2e-6 of its largest, bf16 plus half an ulp), with its layout, partial-row
count and body asserted, and both bodies rerun bit for bit. K6's bf16
tensor-core body also reruns bit for bit, counts its launches, and stays
within twice the FMA body's error against the chunked form in f64.
"""
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import (_plain_decode,
                                                  decode_attention,
                                                  split_layout)
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


def _hopper_body(d):
    """Whether bf16 attention of head width d runs the Hopper bodies (base-2
    softmax) rather than the FMA ones."""
    return d % 16 == 0 and d <= 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,d,window", [
    (2, 268, 8, 8, 128, None),     # ragged prefill, MHA
    (2, 100, 8, 2, 64, None),      # GQA
    (1, 77, 4, 1, 64, 16),         # MQA + window
    (3, 13, 4, 4, 256, None),      # the service's short prompt, wide head
    (1, 40, 2, 2, 8, 5),           # narrowest head
    (2, 256, 32, 32, 64, None),    # zamba2-1.2b's shared attention
    (8, 13, 32, 32, 128, None),    # openvla-7b's serving prompt
    (8, 12, 32, 32, 64, None),     # zamba2-1.2b's, the env's prompt
    (4, 275, 32, 32, 128, None),   # openvla-7b's train sequence, with LSE
    (2, 275, 8, 2, 128, 150),      # GQA, a window over three key tiles
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
    (2, 268, 8, 8, 128, None),     # Hopper body, ragged prefill
    (2, 100, 8, 2, 64, 16),        # Hopper body, GQA + window
    (8, 13, 32, 32, 128, None),    # Hopper body, the serving prompt
    (1, 50, 2, 2, 80, None),       # Hopper body, a head padded to 128
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
    exp, _ = tiled_softmax_attention(q, k, v, ok[None, None],
                                     base2=_hopper_body(d))
    _check_order(out, exp)


def _kernel_split(s):
    """K2's split layout over a cache of s slots, as the oracle takes it."""
    return split_layout(s)[1] * 64


@pytest.mark.parametrize("b,s,h,kv,d", [(8, 275, 8, 8, 128),
                                        (1, 33, 32, 4, 256)])
def test_decode_bf16_body_matches_kernel_order(dev, b, s, h, kv, d):
    g = torch.Generator(device=dev).manual_seed(s + d)
    q = _exact_qk(g, (b, 1, h, d), dev)
    k = _exact_qk(g, (b, s, kv, d), dev)
    v = torch.randn(b, s, kv, d, generator=g, device=dev).bfloat16()
    valid = torch.rand(b, s, generator=g, device=dev) > 0.4
    valid[:, 0] = True
    exp, _ = tiled_softmax_attention(q, k, v, valid[:, None, None, :],
                                     split=_kernel_split(s))
    _check_order(decode_attention(q, k, v, valid), exp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,masked", [
    (2, 275, 8, 8, 128, (192, 275)),   # the last two splits wholly masked
    (2, 263, 32, 32, 64, (64, 128)),   # zamba2's cache, a middle split masked
    (3, 1, 4, 4, 64, None),            # one slot
    (2, 64, 8, 2, 128, None),          # one tile, one split
    (2, 65, 8, 2, 128, None),          # one slot past it: two splits
    (1, 512, 4, 4, 64, None),          # eight splits of one tile
    (1, 513, 4, 4, 64, (384, 513)),    # five of two tiles, the last masked
    (2, 275, 32, 8, 128, None),        # G 4
    (2, 200, 32, 4, 256, None),        # G 8, the widest head
    (2, 100, 48, 4, 64, None),         # G 12: two blocks of query heads
])
def test_decode_kernel_split_layouts(dev, dtype, b, s, h, kv, d, masked):
    """K2 over every split layout edge against its plain version, and in
    bf16 against the kernel-order oracle with the split layout."""
    g = torch.Generator(device=dev).manual_seed(s + d + h)
    q = _exact_qk(g, (b, 1, h, d), dev).to(dtype)
    k = _exact_qk(g, (b, s, kv, d), dev).to(dtype)
    v = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
    valid = torch.rand(b, s, generator=g, device=dev) > 0.3
    valid[:, 0] = True
    if masked is not None:
        valid[:, masked[0]:masked[1]] = False
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _check(out, _plain_decode(q, k, v, valid), dtype)
    if dtype == torch.bfloat16:
        exp, _ = tiled_softmax_attention(q, k, v, valid[:, None, None, :],
                                         split=_kernel_split(s))
        _check_order(out, exp)


def test_decode_kernel_reruns_bit_for_bit(dev):
    """K2 at openvla-7b's 275 slots (five splits in a cluster) and at its
    served 20 slots, twice each: identical bits (no atomics)."""
    g = torch.Generator(device=dev).manual_seed(7)
    for s in (275, 20):
        q = torch.randn(8, 1, 32, 128, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(8, s, 32, 128, generator=g, device=dev)
                .bfloat16() for _ in range(2))
        valid = torch.rand(8, s, generator=g, device=dev) > 0.3
        valid[:, 0] = True
        assert torch.equal(decode_attention(q, k, v, valid),
                           decode_attention(q, k, v, valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,h,kv,d,window", [
    (2, 100, 100, 8, 2, 64, None),     # GQA, every key
    (2, 13, 70, 4, 4, 128, None),      # T != S: queries see every key
    (1, 77, 77, 4, 1, 64, 9),          # MQA + window, both directions
    (2, 256, 256, 32, 32, 64, None),   # zamba2's heads
])
def test_flash_kernel_without_causal_mask(dev, dtype, b, t, s, h, kv, d,
                                          window):
    """``causal=False`` (``ops.flash_attention_op``'s option): every key of
    the window, before or after the query."""
    g = torch.Generator(device=dev).manual_seed(t + s)
    q = torch.randn(b, t, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
    out, lse = flash_attention(q, k, v, causal=False, window=window,
                               return_lse=True)
    torch.cuda.synchronize()
    exp, exp_lse = _plain_dense(q, k, v, causal=False, window=window,
                                return_lse=True)
    _check(out, exp, dtype)
    assert (lse - exp_lse).abs().max().item() <= 1e-3


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



# ---------------------------------------------------------------------------
# Training kernels: K3 flash backward, K4 fused policy loss
# ---------------------------------------------------------------------------

def _check_grad(got, exp, dtype):
    """f32: within 1e-4 of the largest value; bf16: one bf16 ulp (2^-7) of
    each value plus 1e-4 of the largest (both sides are f32 inside)."""
    err = (got.float() - exp.float()).abs()
    scale = exp.float().abs().max().item()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert (err - 2.0 ** -7 * exp.float().abs()).max().item() \
            <= 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,d,window", [
    (2, 275, 8, 8, 128, None),     # ragged T, the training head width
    (2, 100, 8, 2, 64, 32),        # GQA + window
    (1, 77, 4, 1, 64, None),       # MQA, ragged
    (3, 50, 4, 4, 16, 5),          # narrow head, short window
    (1, 40, 2, 2, 24, 5),          # D % 16 != 0: the FMA body in bf16 too
    (2, 256, 32, 32, 64, None),    # zamba2-1.2b's shared attention
    (2, 19, 32, 32, 64, None),     # ... on the env's train sequence
    (8, 13, 32, 32, 128, None),    # openvla-7b's heads, one key tile
    (8, 12, 32, 32, 64, None),     # zamba2-1.2b's, one key tile
    (4, 275, 32, 32, 128, None),   # openvla-7b's train sequence
    (2, 275, 8, 2, 128, 150),      # GQA, a window over three key tiles
])
def test_flash_bwd_kernel_matches_plain(dev, dtype, b, t, h, kv, d, window):
    from repro_torch.kernels.flash_attention import (_plain_flash_bwd,
                                                     flash_attention_bwd)
    g = torch.Generator(device=dev).manual_seed(t + d)
    q, do = (torch.randn(b, t, h, d, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, t, kv, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)
    n0 = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    exp = _plain_flash_bwd(q, k, v, o, lse, do, window=window)
    for x, y in zip(got, exp):
        assert x.dtype == y.dtype and x.shape == y.shape
        _check_grad(x, y, dtype)


def test_flash_kernels_rerun_bit_for_bit(dev):
    """K1 with its LSE and K3, each called twice on the same inputs at
    openvla-7b's train shape: identical bits (no atomics, fixed orders)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    g = torch.Generator(device=dev).manual_seed(4)
    q, do = (torch.randn(4, 275, 32, 128, generator=g, device=dev)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(4, 275, 32, 128, generator=g, device=dev)
            .bfloat16() for _ in range(2))
    o1, lse1 = flash_attention(q, k, v, return_lse=True)
    o2, lse2 = flash_attention(q, k, v, return_lse=True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    g1 = flash_attention_bwd(q, k, v, o1, lse1, do)
    g2 = flash_attention_bwd(q, k, v, o1, lse1, do)
    for x, y in zip(g1, g2):
        assert torch.equal(x, y)


def _policy_inputs(dev, n, d, va, dtype, seed, stale=False):
    """K4's inputs. logp_old: the logits' own log-prob of the target plus
    0.1 N(0, 1) (ω near 0.9), or, ``stale``, -5 ± 0.3 (ω near 0)."""
    from repro_torch.kernels.gipo_loss import _logits32
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, d, generator=g, device=dev).to(dtype)
    w = (torch.randn(d, va, generator=g, device=dev) * d ** -0.5).to(dtype)
    tg = torch.randint(0, va, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    noise = torch.randn(n, generator=g, device=dev)
    if stale:
        lo = noise * 0.3 - 5.0
    else:
        logp = torch.log_softmax(_logits32(h, w), dim=-1)
        lo = logp.gather(1, tg.long()[:, None])[:, 0] + 0.1 * noise
    return [h, w, tg, lo, torch.randn(n, generator=g, device=dev),
            (torch.rand(n, generator=g, device=dev) > 0.15).float()]


def _policy_body_expected(dtype):
    """K4 runs its tensor-core body on bf16, its FMA body on f32."""
    return "tensor cores" if dtype == torch.bfloat16 else "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,va,stale", [
    (224, 4096, 256, False),       # the training slice's micro-batch
    (224, 2560, 256, False),       # the same at mamba2-2.7b's width
    (224, 2048, 256, False),       # ... and at zamba2-1.2b's
    (300, 64, 48, False),          # ragged N, Va off the 16-grid, 4 ranks
    (37, 128, 128, False),         # ragged, 8 ranks of 16 rows of d
    (224, 4096, 256, True),        # stale behaviour log-probs: ω near 0
    (225, 4096, 256, False),       # one row into a new tile
    (17, 2560, 256, False),        # fewer rows than a tile
    (224, 2056, 192, False),       # d off the 16-grid: a slice past d
    (224, 4096, 64, False),        # Va 64
    (40, 6144, 64, False),         # d > 4096: w's slice streams (bf16)
])
def test_policy_loss_kernel_matches_plain(dev, dtype, n, d, va, stale):
    from repro_torch.kernels import build
    from repro_torch.kernels import gipo_loss as gl
    args = _policy_inputs(dev, n, d, va, dtype, n + va, stale)
    coefs = torch.tensor([0.7, 0.1, -0.01], device=dev) / n
    body = gl.policy_body(args[0], args[1])
    assert body == _policy_body_expected(dtype)
    tc = body == "tensor cores"
    rows = build.load().policy_loss_partial_rows(n, d, va,
                                                 int(dtype != torch.float32))
    if tc:      # 1-16 ranks a tile of 32 rows, slices of 16-row multiples
        sl, ranks = gl.policy_slice(args[0], args[1]), rows // -(-n // 32)
        assert rows % -(-n // 32) == 0 and ranks in (1, 2, 4, 8, 16)
        assert sl % 16 == 0 and ranks * (sl - 16) < d <= ranks * sl
    else:
        assert rows == -(-n // 16)
    n0 = (gl.policy_loss_fwd.launches, gl.policy_loss_bwd.launches,
          gl.policy_loss_fwd.tc.launches, gl.policy_loss_bwd.tc.launches)
    partials = gl.policy_loss_fwd(*args, 0.2)
    got = gl._finalize(partials.sum(0))
    dh, dw = gl.policy_loss_bwd(*args, 0.2, coefs)
    torch.cuda.synchronize()
    assert tuple(partials.shape) == (rows, 8)
    assert (gl.policy_loss_fwd.launches, gl.policy_loss_bwd.launches,
            gl.policy_loss_fwd.tc.launches, gl.policy_loss_bwd.tc.launches) \
        == (n0[0] + 1, n0[1] + 1, n0[2] + tc, n0[3] + tc)
    exp = gl._finalize(gl._plain_policy_loss_fwd(*args, 0.2).sum(0))
    assert stale or got[3]["omega_mean"].item() > 0.5    # live data
    for x, y in zip(list(got[:3]) + list(got[3].values()),
                    list(exp[:3]) + list(exp[3].values())):
        assert abs(x.item() - y.item()) <= 1e-4 * max(abs(y.item()), 1.0)
    edh, edw = gl._plain_policy_loss_bwd(*args, 0.2, coefs)
    assert dh.dtype == args[0].dtype and dw.dtype == args[1].dtype
    _check_grad(dh, edh, dtype)
    _check_grad(dw, edw, dtype)


def _exact_policy_inputs(dev, n, d, va, seed):
    """bf16 inputs whose logits are exact in f32 in any order (h = k / 8,
    w = k / 4096, |k| <= 16), with live behaviour log-probs."""
    from repro_torch.kernels.gipo_loss import _logits32
    g = torch.Generator(device=dev).manual_seed(seed)
    h = (torch.randint(-16, 17, (n, d), generator=g, device=dev) / 8) \
        .bfloat16()
    w = (torch.randint(-16, 17, (d, va), generator=g, device=dev) / 4096) \
        .bfloat16()
    tg = torch.randint(0, va, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    logp = torch.log_softmax(_logits32(h, w), dim=-1)
    lo = logp.gather(1, tg.long()[:, None])[:, 0] \
        + 0.1 * torch.randn(n, generator=g, device=dev)
    return [h, w, tg, lo, torch.randn(n, generator=g, device=dev),
            (torch.rand(n, generator=g, device=dev) > 0.15).float()]


@pytest.mark.parametrize("n,d,va", [
    (224, 4096, 256), (224, 2560, 256), (224, 2048, 256),   # main paths
    (3584, 4096, 256),             # the large batch
    (225, 2056, 192), (17, 4096, 64), (300, 64, 48),
    (224, 6144, 256), (40, 8192, 64),   # slices past 256 rows stream
])
def test_policy_loss_tc_body_matches_kernel_order(dev, n, d, va):
    """K4's tensor-core body against ref.tiled_policy_loss (its order of
    arithmetic) on inputs whose logits are exact: the loss and metrics
    within 1e-5 relative (floored at 1), dh and dw (bf16) within half a
    bf16 ulp of the oracle's f32 values plus 1e-5 of the largest (f32 sums
    in other orders)."""
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels.ref import tiled_policy_loss
    args = _exact_policy_inputs(dev, n, d, va, n + d)
    coefs = torch.tensor([0.7, 0.1, -0.01], device=dev) / n
    assert gl.policy_body(args[0], args[1]) == "tensor cores"
    got = gl._finalize(gl.policy_loss_fwd(*args, 0.2).sum(0))
    dh, dw = gl.policy_loss_bwd(*args, 0.2, coefs)
    sums, edh, edw = tiled_policy_loss(
        *args, 0.2, coefs, d_slice=gl.policy_slice(args[0], args[1]))
    exp = gl._finalize(sums)
    for x, y in zip(list(got[:3]) + list(got[3].values()),
                    list(exp[:3]) + list(exp[3].values())):
        assert abs(x.item() - y.item()) <= 1e-5 * max(abs(y.item()), 1.0)
    for x, y in ((dh, edh), (dw, edw)):
        excess = ((x.float() - y).abs() - 2.0 ** -8 * y.abs()).max().item()
        assert excess <= 1e-5 * y.abs().max().item()


def test_policy_loss_sums_ranks_in_order(dev):
    """K4's tensor-core body sums the ranks' partial logits in rank order.
    Each rank's partial is one exact product (the other products are 0):
    rank 0's b (|b| <= 8, multiples of 1/32), and in the first half of the
    columns rank 2's 2^24 and rank 3's -2^24. In rank order b + 2^24 rounds
    b to an integer (to a multiple of 2 above 0) and -2^24 leaves that; in
    reverse or as a tree the large terms cancel first and b stays exact.
    The body is held within the kernel-order bars against the oracle, whose
    slices sum in rank order, and its forward is shown 100x past those bars
    against the exact logits b."""
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels.ref import tiled_policy_loss
    n, d, va = 224, 4096, 256
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.zeros(n, d, device=dev)
    w = torch.zeros(d, va, device=dev)
    sl = gl.policy_slice(h.bfloat16(), w.bfloat16())
    h[:, 5] = torch.randint(1, 17, (n,), generator=g, device=dev) / 4
    w[5] = torch.randint(-64, 65, (va,), generator=g, device=dev) / 8
    big = (2 * sl + 7, 3 * sl + 9)     # rows of d in ranks 2 and 3
    h[:, big[0]], h[:, big[1]] = 2.0 ** 12, -2.0 ** 12
    w[big[0], :va // 2] = w[big[1], :va // 2] = 2.0 ** 12
    h, w = h.bfloat16(), w.bfloat16()
    tg = torch.randint(0, va, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    b = h[:, 5:6].float() * w[5:6].float()
    lo = torch.log_softmax(b, -1).gather(1, tg.long()[:, None])[:, 0] \
        + 0.1 * torch.randn(n, generator=g, device=dev)
    rows = [tg, lo, torch.randn(n, generator=g, device=dev),
            (torch.rand(n, generator=g, device=dev) > 0.15).float()]
    coefs = torch.tensor([0.7, 0.1, -0.01], device=dev) / n
    got = gl._finalize(gl.policy_loss_fwd(h, w, *rows, 0.2).sum(0))
    dh, dw = gl.policy_loss_bwd(h, w, *rows, 0.2, coefs)

    def fwd_excess(sums):
        exp = gl._finalize(sums)
        return max(abs(x.item() - y.item()) / (1e-5 * max(abs(y.item()), 1))
                   for x, y in zip(list(got[:3]) + list(got[3].values()),
                                   list(exp[:3]) + list(exp[3].values())))
    sums, edh, edw = tiled_policy_loss(h, w, *rows, 0.2, coefs, d_slice=sl)
    assert fwd_excess(sums) <= 1.0
    for x, y in ((dh, edh), (dw, edw)):
        excess = ((x.float() - y).abs() - 2.0 ** -8 * y.abs()).max().item()
        assert excess <= 1e-5 * y.abs().max().item()
    h0 = h.clone()
    h0[:, list(big)] = 0               # the logits are b, exactly
    assert fwd_excess(tiled_policy_loss(h0, w, *rows, 0.2, coefs,
                                        d_slice=sl)[0]) > 100.0


@pytest.mark.parametrize("n,d", [(224, 4096), (3584, 4096), (224, 6144)])
def test_policy_loss_backward_is_deterministic(dev, n, d):
    from repro_torch.kernels import gipo_loss as gl
    args = _policy_inputs(dev, n, d, 256, torch.bfloat16, 1)
    coefs = torch.tensor([0.7, 0.1, -0.01], device=dev) / n
    dh1, dw1 = gl.policy_loss_bwd(*args, 0.2, coefs)
    dh2, dw2 = gl.policy_loss_bwd(*args, 0.2, coefs)
    assert torch.equal(dh1, dh2) and torch.equal(dw1, dw2)


def test_backward_through_attention_reaches_every_projection(dev):
    """No silent loss of the grad: K3 runs, and wq/wk/wv/wo all get a
    nonzero gradient."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models.attention import attention_forward
    g = torch.Generator(device=dev).manual_seed(0)
    params = {n: (torch.randn(*s, generator=g, device=dev) * 0.05)
              .bfloat16().requires_grad_(True)
              for n, s in (("wq", (256, 2, 128)), ("wk", (256, 2, 128)),
                           ("wv", (256, 2, 128)), ("wo", (2, 128, 256)))}
    x = torch.randn(3, 40, 256, generator=g, device=dev).bfloat16()
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    attention_forward(params, x, rope_theta=10000.0).float().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    for name, p in params.items():
        assert p.grad is not None and p.grad.abs().max().item() > 0, name


def test_training_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q = torch.randn(1, 16, 2, 64, device=dev)
    o, lse = flash_attention(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="head_dim"):
        w = torch.randn(1, 16, 2, 256, device=dev)
        flash_attention_bwd(w, w, w, w, lse, w)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, o, lse.double(), q)
    with pytest.raises(ValueError, match="do must"):
        flash_attention_bwd(q, q, q, o, lse, q.transpose(1, 2)
                            .contiguous().transpose(1, 2))
    args = _policy_inputs(dev, 32, 64, 48, torch.float32, 0)
    for i, bad, match in ((0, args[0].half(), "float32 or bfloat16"),
                          (2, args[2].long(), "int32"),
                          (5, args[5].cpu(), "CUDA tensor"),
                          (1, torch.randn(64, 512, device=dev), "Va")):
        with pytest.raises(ValueError, match=match):
            gl.policy_loss_fwd(*args[:i], bad, *args[i + 1:], 0.2)


# ---------------------------------------------------------------------------
# SSD scan kernels: K6 forward, K7 backward
# ---------------------------------------------------------------------------

def _ssd_inputs(dev, b, t, h, p, n, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, t, h, p, generator=g, device=dev).to(dtype),
            torch.rand(b, t, h, generator=g, device=dev) * 0.09 + 0.01,
            -(torch.rand(h, generator=g, device=dev) + 0.5),
            torch.randn(b, t, n, generator=g, device=dev).to(dtype),
            torch.randn(b, t, n, generator=g, device=dev).to(dtype)]


def _check_f32_out(got, exp):
    """An f32 output of an f32-inside kernel: within 1e-4 of the largest
    value, whatever the inputs' dtype."""
    assert got.dtype == exp.dtype == torch.float32
    scale = exp.abs().max().item()
    assert (got - exp).abs().max().item() <= 1e-4 * scale


def _tc_body(dtype, t, p, n, chunk):
    """Whether K6 runs its tensor-core body: bf16, the kernels' chunk
    (``chunk``, or T rounded up to 32) <= 128, P <= 64, N <= 128."""
    q = min(chunk, -(-t // 32) * 32)
    return dtype == torch.bfloat16 and q <= 128 and p <= 64 and n <= 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (2, 64, 3, 16, 8, 32),         # small (bf16: tensor cores, padded)
    (2, 192, 2, 32, 16, 64),       # three chunks
    (1, 256, 4, 64, 128, 128),     # mamba2-2.7b's head and chunk
    (2, 200, 2, 32, 16, 64),       # a short last chunk (8 of 64)
    (8, 12, 4, 64, 128, 128),      # the env's prompt, T_OBS = 12
    (4, 19, 4, 64, 128, 128),      # the env's train sequence, 12 + 7
    (1, 300, 4, 64, 128, 128),     # two chunks and 44 steps
    (2, 256, 64, 64, 64, 128),     # zamba2-1.2b: H 64, P 64, N 64
    (8, 12, 64, 64, 64, 128),      # ... the env's prompt
    (4, 19, 64, 64, 64, 128),      # ... the env's train sequence
    (1, 300, 64, 64, 64, 128),     # ... two chunks and 44 steps
    (2, 256, 80, 64, 128, 128),    # mamba2-2.7b: H 80, P 64, N 128
    (8, 12, 80, 64, 128, 128),     # ... the env's prompt
    (4, 19, 80, 64, 128, 128),     # ... the env's train sequence
    (1, 300, 80, 64, 128, 128),    # ... two chunks and 44 steps
    (1, 256, 2, 128, 32, 128),     # FMA body in bf16: P 128
    (1, 256, 2, 16, 16, 256),      # ... chunk 256
])
def test_ssd_scan_kernel_matches_plain(dev, dtype, b, t, h, p, n, chunk):
    from repro_torch.kernels.ssd_scan import (fwd_body, plain_ssd_scan,
                                              ssd_scan)
    args = _ssd_inputs(dev, b, t, h, p, n, dtype, t + p)
    n0, tc0 = ssd_scan.launches, ssd_scan.tc.launches
    y, s, enter = ssd_scan(*args, chunk=chunk, return_states=True)
    y2, s2 = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n0 + 2
    tc = _tc_body(dtype, t, p, n, chunk)
    assert ssd_scan.tc.launches == tc0 + 2 * tc
    assert fwd_body(args[0], args[3], chunk) == ("tensor cores" if tc
                                                 else "fma")
    ey, es, eenter = plain_ssd_scan(*args, chunk, return_states=True)
    for got, exp in ((y, ey), (s, es), (enter, eenter), (y2, ey), (s2, es)):
        _check_f32_out(got, exp)


@pytest.mark.parametrize("n", [128, 64])
@pytest.mark.parametrize("t", [256, 19, 300])
def test_ssd_scan_is_bit_repeatable(dev, t, n):
    """K6's tensor-core body writes every output element from one thread,
    with no atomics: two runs agree bit for bit."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    args = _ssd_inputs(dev, 4, t, 8, 64, n, torch.bfloat16, 7)
    tc0 = ssd_scan.tc.launches
    one = ssd_scan(*args, chunk=128, return_states=True)
    two = ssd_scan(*args, chunk=128, return_states=True)
    assert ssd_scan.tc.launches == tc0 + 2
    for x, y in zip(one, two):
        assert torch.equal(x, y)


def _ssd_f64(x, dt, A, Bm, Cm, q):
    """The chunked SSD form (``plain_ssd_scan``'s) in f64, chunk ``q``
    dividing T: (y, final state, entering states)."""
    b, t, h, p = x.shape
    n, nc = Bm.shape[-1], t // q
    xc = x.double().reshape(b, nc, q, h, p)
    dtc = dt.double().reshape(b, nc, q, h)
    bc = Bm.double().reshape(b, nc, q, n)
    cc = Cm.double().reshape(b, nc, q, n)
    cum = torch.cumsum(dtc * A.double(), dim=2)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    g = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    w = torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None] * g \
        * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                           torch.exp(cum[:, :, -1:] - cum) * dtc, bc, xc)
    s = torch.zeros((b, h, p, n), dtype=torch.float64, device=x.device)
    enter = []
    for c in range(nc):
        enter.append(s)
        s = torch.exp(cum[:, c, -1])[:, :, None, None] * s + s_chunk[:, c]
    enter = torch.stack(enter, 1)
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", cc, enter, torch.exp(cum))
    return y.reshape(b, t, h, p), s, enter


@pytest.mark.parametrize("b,t,h,p,n", [(2, 256, 80, 64, 128),
                                       (2, 256, 64, 64, 64),
                                       (1, 512, 8, 64, 128)])
def test_ssd_tc_body_error_within_twice_the_fma_body(dev, b, t, h, p, n):
    """Against one f64 oracle on the same bf16 inputs (exact in f64), the
    tensor-core body's largest error in y, the final state and the entering
    states is no more than twice the FMA body's (f32 FMAs throughout)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    args = _ssd_inputs(dev, b, t, h, p, n, torch.bfloat16, t + n)
    exp = _ssd_f64(*args, 128)
    tc0 = ssd_scan.tc.launches
    tc = ssd_scan(*args, chunk=128, return_states=True)
    assert ssd_scan.tc.launches == tc0 + 1
    fma = ssd_scan(*args, chunk=128, return_states=True, body="fma")
    assert ssd_scan.tc.launches == tc0 + 1
    for name, x, y, e in zip(("y", "s_final", "s_enter"), tc, fma, exp):
        err_tc = (x.double() - e).abs().max().item()
        err_fma = (y.double() - e).abs().max().item()
        assert err_tc <= 2 * err_fma, (name, err_tc, err_fma)


@pytest.mark.parametrize("dtype,b,t,h,p,n,chunk", [
    (torch.float32, 2, 64, 3, 16, 8, 32),
    (torch.bfloat16, 2, 64, 3, 16, 8, 32),
    (torch.float32, 1, 64, 2, 128, 16, 32),      # P 128
    (torch.float32, 1, 128, 4, 64, 128, 64),     # mamba2 head, f32 fits q 64
    (torch.bfloat16, 2, 256, 4, 64, 128, 128),   # mamba2 head and chunk
    (torch.float32, 2, 200, 3, 16, 8, 64),       # a short last chunk
    (torch.bfloat16, 4, 19, 4, 64, 128, 128),    # the env's train sequence
    (torch.float32, 2, 19, 4, 64, 128, 128),     # ... f32: one chunk of 32
    (torch.bfloat16, 1, 300, 4, 64, 128, 128),   # two chunks and 44 steps
    (torch.bfloat16, 2, 256, 64, 64, 64, 128),   # zamba2-1.2b's SSD
    (torch.float32, 2, 256, 64, 64, 64, 128),    # ... f32 fits q 128 at N 64
    (torch.bfloat16, 2, 12, 64, 64, 64, 128),    # ... the env's prompt
    (torch.bfloat16, 4, 19, 64, 64, 64, 128),    # ... the env's train seq
    (torch.bfloat16, 2, 64, 3, 16, 16, 32),      # tensor-core body, padded
    (torch.bfloat16, 1, 200, 2, 32, 48, 64),     # ... four chunks, short
    (torch.bfloat16, 2, 256, 8, 64, 128, 64),    # ... chunk 64
    (torch.bfloat16, 1, 64, 2, 128, 16, 32),     # FMA body in bf16: P 128
    (torch.bfloat16, 1, 256, 2, 16, 16, 256),    # ... chunk 256
])
def test_ssd_scan_bwd_kernel_matches_plain(dev, dtype, b, t, h, p, n, chunk):
    from repro_torch.kernels.ssd_scan import (plain_ssd_scan_bwd, ssd_scan,
                                              ssd_scan_bwd)
    args = _ssd_inputs(dev, b, t, h, p, n, dtype, t + p + 1)
    _, _, enter = ssd_scan(*args, chunk=chunk, return_states=True)
    g = torch.Generator(device=dev).manual_seed(5)
    dy = torch.randn(b, t, h, p, generator=g, device=dev)
    ds = torch.randn(b, h, p, n, generator=g, device=dev)
    n0 = ssd_scan_bwd.launches
    got = ssd_scan_bwd(*args, enter, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == n0 + 1
    exp = plain_ssd_scan_bwd(*args, enter, dy, ds, chunk)
    for name, x, y in zip(("dx", "ddt", "dA", "dB", "dC"), got, exp):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if y.dtype == torch.float32:
            _check_f32_out(x, y)
        else:
            _check_grad(x, y, dtype)


@pytest.mark.parametrize("n", [128, 64])
@pytest.mark.parametrize("t", [256, 19])
def test_ssd_scan_bwd_is_bit_repeatable(dev, t, n):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    args = _ssd_inputs(dev, 4, t, 8, 64, n, torch.bfloat16, 3)
    _, _, enter = ssd_scan(*args, chunk=128, return_states=True)
    dy = torch.randn(4, t, 8, 64, device=dev)
    ds = torch.randn(4, 8, 64, n, device=dev)
    one = ssd_scan_bwd(*args, enter, dy, ds, chunk=128)
    two = ssd_scan_bwd(*args, enter, dy, ds, chunk=128)
    for x, y in zip(one, two):
        assert torch.equal(x, y)


def test_ssd_scan_fn_gives_every_input_a_gradient(dev):
    """Through ``dispatch.ssd_scan`` with grad on: K6 forward, K7 backward,
    and a loss on y alone still reaches x, dt, A, B and C (the unused final
    state's zero cotangent seeds the sweep)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    args = [v.requires_grad_() for v in
            _ssd_inputs(dev, 2, 128, 4, 64, 128, torch.bfloat16, 0)]
    n0 = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, _ = dispatch.ssd_scan(*args, chunk=64)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (n0[0] + 1,
                                                          n0[1] + 1)
    for name, v in zip(("x", "dt", "A", "B", "C"), args):
        assert v.grad is not None and v.grad.abs().max().item() > 0, name


def test_ssd_routing_sends_every_fresh_scan_to_the_kernel(dev):
    """Every length runs K6, ragged ones (24, the env's 12 and 19)
    included; no grad needed runs K6 alone, grad on adds K7."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    n0 = (ssd_scan.launches, ssd_scan_bwd.launches)
    with torch.no_grad():
        for t in (64, 24, 12, 19):
            dispatch.ssd_scan(*_ssd_inputs(dev, 1, t, 2, 16, 8,
                                           torch.float32, 0), chunk=32)
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (n0[0] + 4, n0[1])
    args = [v.requires_grad_() for v in
            _ssd_inputs(dev, 2, 19, 2, 16, 8, torch.float32, 0)]
    y, _ = dispatch.ssd_scan(*args, chunk=128)
    y.sum().backward()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (n0[0] + 5,
                                                          n0[1] + 1)


def test_ssd_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    args = _ssd_inputs(dev, 1, 96, 2, 16, 8, torch.float32, 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        ssd_scan(*args, chunk=48)
    for i, bad, match in ((0, args[0].half(), "float32 or all bfloat16"),
                          (1, args[1].bfloat16(), "dt and A must be"),
                          (3, args[3].bfloat16(), "float32 or all bfloat16"),
                          (4, args[4].cpu(), "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            ssd_scan(*args[:i], bad, *args[i + 1:], chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                 *args[1:], chunk=32)
    big = _ssd_inputs(dev, 1, 128, 1, 64, 128, torch.float32, 0)
    _, _, enter = ssd_scan(*big, chunk=128, return_states=True)
    with pytest.raises(RuntimeError, match="shared memory"):
        ssd_scan_bwd(*big, enter, torch.zeros(1, 128, 1, 64, device=dev),
                     torch.zeros(1, 1, 64, 128, device=dev), chunk=128)
    # the refusal leaves no error behind for the next launch to report
    ssd_scan(*args, chunk=32)
    torch.cuda.synchronize()
    cpu = [v.cpu() for v in args]
    with dispatch.forced("cuda"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            dispatch.ssd_scan(*cpu, chunk=32)


# ---------------------------------------------------------------------------
# K5: the GIPO loss over given logits
# ---------------------------------------------------------------------------

def _head_inputs(dev, n, v, dtype, seed, stale=False):
    """Logits at the scale of trained action heads, the rest as K4's; row
    0 fully masked, row 1's target past V and row 2's negative. logp_old
    lies within 0.1 of the logits' own log-prob of the target (|log ρ| / σ
    about 0.5: ω near 1, so the surrogate carries weight); ``stale``: -3 ±
    0.3, far from it (ω near 0, the k3-KL's gradient large)."""
    from repro_torch.kernels import gipo_loss as gl
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = (torch.rand(n, generator=g, device=dev) > 0.15).float()
    targets = torch.randint(0, v, (n,), generator=g, device=dev,
                            dtype=torch.int32)
    mask[0] = 0.0
    targets[1:3] = torch.tensor([v, -1], device=dev)
    logits = (torch.randn(n, v, generator=g, device=dev) * 3).to(dtype)
    noise = torch.randn(n, generator=g, device=dev)
    logp_old = (noise * 0.3 - 3.0 if stale else
                gl._softmax_rows(logits.float(), targets)[3] + 0.1 * noise)
    return [logits, targets, logp_old,
            torch.randn(n, generator=g, device=dev), mask]


# K5's backward is held under each loss term alone, so that none hides
# under another, and under the three together: (c_pg, c_kl, c_ent) / N
HEAD_COEFS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
              (0.7, 0.1, -0.01))


def _check_head(args, dtype, stale=False):
    from repro_torch.kernels import gipo_loss as gl
    n = args[0].shape[0]
    n0 = (gl.gipo_head_fwd.launches, gl.gipo_head_bwd.launches)
    got = gl._finalize(gl.gipo_head_fwd(*args, 0.2).sum(0))
    coefs = [torch.tensor(c, device=args[0].device) / n for c in HEAD_COEFS]
    ds = [gl.gipo_head_bwd(*args, 0.2, c) for c in coefs]
    torch.cuda.synchronize()
    assert (gl.gipo_head_fwd.launches, gl.gipo_head_bwd.launches) \
        == (n0[0] + 1, n0[1] + len(coefs))
    exp = gl._finalize(gl._plain_gipo_head_fwd(*args, 0.2).sum(0))
    assert stale or exp[3]["omega_mean"].item() > 0.5
    for x, y in zip(list(got[:3]) + list(got[3].values()),
                    list(exp[:3]) + list(exp[3].values())):
        assert abs(x.item() - y.item()) <= 1e-4 * max(abs(y.item()), 1.0)
    for c, d in zip(coefs, ds):
        ed = gl._plain_gipo_head_bwd(*args, 0.2, c)
        assert d.dtype == args[0].dtype and d.shape == args[0].shape
        _check_grad(d, ed, dtype)
        assert not d[0].any()                        # the masked row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [
    (257, 48),          # ragged N, the reference tests' shapes
    (300, 64),
    (100, 256),
    (224, 256),         # one train micro-batch of action tokens
    (1000, 1024),       # benchmarks/fused_loss.py's wide vocabulary
    (77, 37),           # V off the vector width: scalar heads and tails
    (9, 1),             # V = 1
    (600, 1024),        # the register body's limit on V
    (600, 1025),        # one past it: the streaming body
    (4224, 250),        # 4 lanes a row in bf16, heads and tails of 2 to 6
    (4224, 37),         # 4 lanes a row, heads and tails of 1 to 7 in bf16
    # N whose last block of rows lacks one, is full, or holds one row (f32
    # 16 lanes a row, 2 rows a block; f32 8 and bf16 4 lanes, 4 and 8 rows
    # at V 256; bf16 8 lanes, 4 rows at V 512)
    (1057, 512), (1058, 512), (1059, 512), (2119, 256), (2120, 256),
    (2121, 256), (2119, 512), (2120, 512), (2121, 512), (4231, 256),
    (4232, 256), (4233, 256),
])
def test_gipo_head_kernel_matches_plain(dev, dtype, n, v):
    _check_head(_head_inputs(dev, n, v, dtype, n + v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(257, 48), (224, 256), (1000, 1024)])
def test_gipo_head_kernel_matches_plain_on_stale_logp(dev, dtype, n, v):
    """logp_old far from the logits' log-probs: ω near 0 and the k3-KL's
    gradient up to ~1e3."""
    _check_head(_head_inputs(dev, n, v, dtype, n + v, stale=True), dtype,
                stale=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(65, 64), (2112, 61), (4224, 256),
                                 (4224, 250)])
def test_gipo_head_kernel_takes_rows_off_16_bytes(dev, dtype, n, v):
    """A logits view starting one element into its storage: loads and
    stores start with a scalar head, d_logits at the logits' offset; the
    register body also against its order of arithmetic."""
    args = _head_inputs(dev, n, v, dtype, 4)
    base = torch.empty(n * v + 1, dtype=dtype, device=dev)
    base[1:].copy_(args[0].reshape(-1))
    args[0] = base[1:].view(n, v)
    assert args[0].data_ptr() % 16
    _check_head(args, dtype)
    _check_head_order(args, torch.tensor([0.7, 0.1, -0.01], device=dev) / n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(16384, 256), (16384, 1024), (4096, 2048)])
def test_gipo_head_backward_is_bit_repeatable(dev, dtype, n, v):
    """Both passes twice, bit for bit, on the register body (V <= 1024, at
    its limit too) and on the streaming body past it."""
    from repro_torch.kernels import gipo_loss as gl
    args = _head_inputs(dev, n, v, dtype, 1)
    assert gl.head_body(args[0]) == ("registers" if v <= 1024
                                     else "streaming")
    coefs = torch.tensor([0.7, 0.1, -0.01], device=dev) / n
    one = gl.gipo_head_bwd(*args, 0.2, coefs)
    two = gl.gipo_head_bwd(*args, 0.2, coefs)
    assert torch.equal(one, two)
    p1, p2 = (gl.gipo_head_fwd(*args, 0.2) for _ in range(2))
    assert torch.equal(p1, p2)


# (N, V, dtype) -> (lanes a row, rows a block) of K5's plan
# (csrc/gipo_loss.cu::head_plan; lanes 0: the streaming body), the layouts
# tests/test_torch_ops.py holds the kernel-order oracle at
HEAD_LAYOUTS = [
    (257, 48, torch.float32, 32, 1), (300, 64, torch.float32, 32, 1),
    (100, 256, torch.float32, 32, 1), (224, 256, torch.float32, 32, 1),
    (77, 37, torch.float32, 32, 1), (9, 1, torch.float32, 32, 1),
    (1056, 512, torch.float32, 16, 2), (2112, 256, torch.float32, 8, 4),
    (4224, 128, torch.float32, 4, 8), (4224, 256, torch.bfloat16, 4, 8),
    (65536, 256, torch.bfloat16, 4, 8), (16384, 1024, torch.float32, 32, 1),
    (16384, 1024, torch.bfloat16, 16, 2), (16384, 1025, torch.float32, 0, 8),
    # a last block of rows that holds one row, and one or two rows in all
    (1, 256, torch.float32, 32, 1), (2, 256, torch.bfloat16, 32, 1),
    (1057, 512, torch.float32, 16, 2), (2121, 256, torch.float32, 8, 4),
    (2121, 512, torch.bfloat16, 8, 4), (4233, 256, torch.bfloat16, 4, 8),
]


@pytest.mark.parametrize("n,v,dtype,lanes,rows", HEAD_LAYOUTS)
def test_gipo_head_layout_is_the_plan(dev, n, v, dtype, lanes, rows):
    """K5's layout and partial-row count as the C queries report them on
    the H100 SXM's 132 SMs, and the forward's partials, one row a
    block."""
    from repro_torch.kernels import build
    from repro_torch.kernels import gipo_loss as gl
    logits = torch.zeros((n, v), dtype=dtype, device=dev)
    assert gl.head_layout(logits) == (lanes, rows)
    assert gl.head_body(logits) == ("registers" if lanes else "streaming")
    code = 0 if dtype == torch.float32 else 1
    assert build.load().gipo_head_partial_rows(n, v, code) == -(-n // rows)
    rest = [torch.zeros(n, dtype=torch.int32, device=dev)] \
        + [torch.zeros(n, device=dev) for _ in range(3)]
    assert gl.gipo_head_fwd(logits, *rest, 0.2).shape == (-(-n // rows), 8)


def _check_head_order(args, coefs):
    """K5's register body against ref.tiled_gipo_head_loss at the layout it
    reports: the partial rows within 2e-6 of each column's largest value,
    d_logits within 2e-6 of its largest value (bf16: plus half a bf16 ulp
    of each value: the kernel rounds its f32 d once)."""
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels.ref import tiled_gipo_head_loss
    logits = args[0]
    lanes, rows = gl.head_layout(logits)
    assert lanes
    parts = gl.gipo_head_fwd(*args, 0.2)
    d = gl.gipo_head_bwd(*args, 0.2, coefs)
    ep, ed = tiled_gipo_head_loss(
        *args, 0.2, coefs, lanes=lanes, block_rows=rows,
        offset=logits.data_ptr() % 16 // logits.element_size())
    assert ((parts - ep).abs() <= 2e-6 * ep.abs().amax(0)).all()
    rt = 0.0 if logits.dtype == torch.float32 else 2.0 ** -8
    assert ((d.float() - ed).abs() - rt * ed.abs()).max() \
        <= 2e-6 * ed.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v,stale", [
    (257, 48, False), (300, 64, True), (224, 256, False), (77, 37, True),
    (9, 1, False), (2112, 256, True), (1056, 512, False),
    (4000, 1024, False), (4224, 256, True), (4224, 96, False),
    (4224, 250, False), (4224, 37, True),
])
def test_gipo_head_register_body_matches_kernel_order(dev, dtype, n, v,
                                                      stale):
    args = _head_inputs(dev, n, v, dtype, 5 * n + v, stale=stale)
    coefs = torch.tensor([0.7, 0.1, -0.01], device=dev) / n
    _check_head_order(args, coefs)


def test_gipo_loss_routes_and_ops_launch_their_kernels(dev):
    """``dispatch.gipo_loss`` and every op of ``kernels.ops`` on CUDA
    tensors launch their kernels; ``forced("torch")`` launches none."""
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan
    args = _head_inputs(dev, 64, 48, torch.float32, 0)
    args[0].requires_grad_()
    n0 = (gl.gipo_head_fwd.launches, gl.gipo_head_bwd.launches)
    pg, ent, kl, _ = dispatch.gipo_loss(*args, sigma=0.2)
    (pg + 0.1 * kl - 0.01 * ent).backward()
    assert (gl.gipo_head_fwd.launches,
            gl.gipo_head_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    with dispatch.forced("torch"):
        dispatch.gipo_loss(*args, sigma=0.2)
    ops.gipo_loss_op(*args)
    ops.gipo_head_loss_op(*args)
    assert gl.gipo_head_fwd.launches == n0[0] + 3
    h = torch.randn(64, 64, device=dev)
    w = torch.randn(64, 48, device=dev)
    n1 = gl.policy_loss_fwd.launches
    ops.fused_policy_loss_op(h, w, *args[1:])
    assert gl.policy_loss_fwd.launches == n1 + 1
    q = torch.randn(1, 16, 2, 64, device=dev)
    n2 = flash_attention.launches
    ops.flash_attention_op(q, q, q, causal=False)
    assert flash_attention.launches == n2 + 1
    n3 = ssd_scan.launches
    ops.ssd_scan_op(*_ssd_inputs(dev, 1, 64, 2, 16, 8, torch.float32, 0),
                    chunk=32)
    assert ssd_scan.launches == n3 + 1


def test_gipo_head_kernel_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels import gipo_loss as gl
    args = _head_inputs(dev, 32, 48, torch.float32, 0)
    for i, bad, match in ((0, args[0].half(), "float32 or bfloat16"),
                          (0, args[0].t(), "contiguous"),
                          (1, args[1].long(), "int32"),
                          (2, args[2][:16], "shape"),
                          (4, args[4].cpu(), "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            gl.gipo_head_fwd(*args[:i], bad, *args[i + 1:], 0.2)
    with pytest.raises(ValueError, match="coefs"):
        gl.gipo_head_bwd(*args, 0.2, torch.zeros(3, device=dev).double())
