"""Oracles for the kernels: the dense attention allclose target, the
attention kernels' own order of arithmetic for holding their bf16 bodies
tightly, the unfused token-level GIPO loss, K4 in the order of its
tensor-core body, K5 in the order of its register body, the stepwise SSD
recurrence, and the SSD scan in the order of K6's tensor-core body."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_TILE = 64          # keys per tile in csrc/flash_attention.cu and
                          # csrc/decode_attention.cu
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def tiled_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, ok: torch.Tensor,
                            *, tile: int = KERNEL_TILE, base2: bool = False,
                            split: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention in the CUDA kernels' order of arithmetic, in f32.

    Keys go in tiles of ``tile``; scores are ``(q . k) * scale`` in f32; the
    running max starts at NEG_INF; ``P = exp(s - m)`` is rounded to
    ``q.dtype`` before the value product while ``l`` sums the unrounded P.
    ``base2`` is the Hopper body of K1 (bf16, D % 16 == 0, D <= 128): the
    scale is ``scale * log2(e)``, rounded once to f32 from the f32 scale,
    and the exponentials are ``exp2``; the LSE still comes out in natural
    log. ``split`` (a multiple of ``tile``) is K2's layout: each run of
    ``split`` keys walks its own tiles from its own running max, and the
    runs' (m, l, acc) then combine in order, each weighted by
    ``exp(m_run - max m)``. q: [B,T,H,D]; k/v: [B,S,KV,D]; ok: bool,
    broadcastable to [B,H,T,S]. Returns the output before its final
    rounding [B,T,H,D] f32 and the log-sum-exp [B,T,H] f32.

    Given inputs whose dot products are exact in f32 in any order, the
    kernels' P are bit-identical to these, so their bf16 output lies within
    half a bf16 ulp of this one plus f32 reordering error."""
    b, t, h, d = q.shape
    s, group = k.shape[1], h // k.shape[2]
    scale = d ** -0.5
    if base2:
        scale = float(torch.tensor(scale, dtype=torch.float32)) * LOG2E
    exp = torch.exp2 if base2 else torch.exp
    qf = q.float().transpose(1, 2)                            # [B,H,T,D]
    kf = k.float().repeat_interleave(group, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, 2).transpose(1, 2)
    ok = ok.expand(b, h, t, s)
    split = s if split is None else split
    runs = []
    for r0 in range(0, s, split):
        m = torch.full((b, h, t, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, t, 1), device=q.device)
        acc = torch.zeros((b, h, t, d), device=q.device)
        for s0 in range(r0, min(r0 + split, s), tile):
            sc = (qf @ kf[:, :, s0:s0 + tile].transpose(-1, -2)) * scale
            sc = sc.masked_fill(~ok[..., s0:s0 + tile], float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = exp(sc - m_new)
            corr = exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(q.dtype).float() @ vf[:, :, s0:s0 + tile]
            m = m_new
        runs.append((m, l, acc))
    if len(runs) > 1:        # a wholly masked run keeps m = NEG_INF: weight 0
        m = torch.stack([r[0] for r in runs]).amax(0)
        l, acc = torch.zeros_like(l), torch.zeros_like(acc)
        for m_r, l_r, acc_r in runs:
            w = exp(m_r - m)
            l = l + l_r * w
            acc = acc + acc_r * w
    l = l.clamp_min(1e-30)
    lse = (m + torch.log2(l)) * LN2 if base2 else m + torch.log(l)
    return (acc / l).transpose(1, 2), lse.squeeze(-1).transpose(1, 2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Dense GQA attention in f32. q: [B,T,H,D]; k/v: [B,S,KV,D] ->
    [B,T,H,D] in q.dtype."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, t, kv, group, d).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * (d ** -0.5)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def reference_gipo_loss(logits: torch.Tensor, targets: torch.Tensor,
                        logp_old: torch.Tensor, advantages: torch.Tensor,
                        mask: torch.Tensor, sigma: float
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Unfused token-level GIPO (eqs. 5-6), as the reference's
    ``repro/kernels/ref.py::reference_gipo_loss``. logits: [N, V]; rest
    [N]. Returns (pg loss, {"ratio_mean", "omega_mean"})."""
    logp_all = torch.log_softmax(logits.float(), dim=-1)
    logp_new = logp_all.gather(-1, targets.long()[:, None])[:, 0]
    log_ratio = logp_new - logp_old
    ratio = torch.exp(log_ratio)
    omega = torch.exp(-0.5 * (log_ratio.detach() / sigma).square())
    per_token = -(omega * ratio * advantages)
    denom = torch.clamp_min(mask.sum(), 1.0)
    metrics = {"ratio_mean": (ratio * mask).sum() / denom,
               "omega_mean": (omega * mask).sum() / denom}
    return (per_token * mask).sum() / denom, metrics


def tiled_policy_loss(hidden: torch.Tensor, w: torch.Tensor,
                      targets: torch.Tensor, logp_old: torch.Tensor,
                      advantages: torch.Tensor, mask: torch.Tensor,
                      sigma: float, coefs: torch.Tensor, *, d_slice: int,
                      terms: int = 3
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 (the fused action head + GIPO loss) in the order of arithmetic of
    its tensor-core body (``csrc/gipo_loss.cu``: ``policy_cluster_kernel``
    and ``policy_dw_tc_kernel``), in f32.

    The logits are partial products over consecutive slices of ``d_slice``
    rows of d (a cluster rank's, ``gipo_loss.policy_slice``), summed in
    rank order; each partial sums exact products of the inputs in f32. The
    row terms follow as ``_fwd_partials`` and ``_block_dlogits``. d (f32)
    enters dh = d . w^T and dw = h^T . d as ``terms`` bf16 terms
    (``split_bf16``), each term's product summed in f32 and the terms added
    largest first. ``coefs`` is the (c_pg, c_kl, c_ent) row. Returns (the 8
    partial sums over all rows, dh [N, d], dw [d, Va]), f32, before any
    rounding to the inputs' dtype."""
    from repro_torch.kernels.gipo_loss import _block_dlogits, _fwd_partials
    h32, w32 = hidden.float(), w.float()
    logits = h32[:, :d_slice] @ w32[:d_slice]
    for k0 in range(d_slice, hidden.shape[1], d_slice):
        logits = logits + h32[:, k0:k0 + d_slice] @ w32[k0:k0 + d_slice]
    rows = (targets, logp_old, advantages, mask, sigma)
    sums = _fwd_partials(logits, *rows)
    dl = _block_dlogits(logits, *rows, coefs[0], coefs[1], coefs[2])
    dh = dw = None
    for t in split_bf16(dl, terms):
        dh = t @ w32.T if dh is None else dh + t @ w32.T
        dw = h32.T @ t if dw is None else dw + h32.T @ t
    return sums, dh, dw


def tiled_gipo_head_loss(logits: torch.Tensor, targets: torch.Tensor,
                         logp_old: torch.Tensor, advantages: torch.Tensor,
                         mask: torch.Tensor, sigma: float,
                         coefs: torch.Tensor, *, lanes: int, block_rows: int,
                         offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 (the GIPO loss over given logits) in the order of arithmetic of
    its register body (``csrc/gipo_loss.cu``, ``gipo_rows_kernel``), in
    f32.

    The layout is the body's (``gipo_loss.head_layout``): a row over
    ``lanes`` lanes, ``block_rows`` consecutive rows a block (a warp's, one
    partial row each). ``offset`` is the logits' first element's place
    within 16 bytes, in elements: of row n's head (its elements before a
    16-byte boundary) and of the tail past its last whole 16-byte vector,
    lane j takes elements j, j + lanes, ..., and of the vectors in between
    vectors j, j + lanes, ... Every element of a row is in one lane's list
    (asserted). The exponentials are base 2, as K1's: sh = s - max, e =
    2^(sh log2 e) with log2 e and the product in f32. Each lane sums e over
    its elements in its order (head, vectors, tail) from 0, and e sh into
    U by fused multiply-add; the lanes' sums combine in a butterfly
    (offsets lanes / 2 down to 1, each lane adding its partner's). Then lse
    = log S, H = lse - U / S, the row terms as ``_fwd_partials``, and each
    block's 8 columns summed over its rows in order from 0. d = g (onehot
    - p) + c_ent m (-p ((s - max - lse) + H)) with p = e (1 / S), 0 on rows
    with mask 0; ``coefs`` is the (c_pg, c_kl, c_ent) row. Returns (the
    partial rows [ceil(N / block_rows), 8], d_logits [N, V]), f32, d before
    any rounding to the logits' dtype."""
    n, v = logits.shape
    width = 16 // logits.element_size()
    dev = logits.device
    x = logits.float()
    start = offset + torch.arange(n, device=dev) * v
    head = torch.clamp((width - start % width) % width, max=v)
    nvec = (v - head) // width
    tail0 = head + nvec * width
    j = torch.arange(lanes, device=dev)
    k = torch.arange(max(1, -(-int(nvec.max()) // lanes)), device=dev)
    chunk = j[:, None] + k[None, :] * lanes                   # [lanes, nv]
    vcols = (head[:, None, None, None] + chunk[None, :, :, None] * width
             + torch.arange(width, device=dev))
    vcols = torch.where(chunk[None, :, :, None] < nvec[:, None, None, None],
                        vcols, -1).flatten(2)
    # a head or tail holds up to width - 1 elements: ht a lane
    ht = torch.arange(-(-(width - 1) // lanes), device=dev)
    jh = j[:, None] + ht[None, :] * lanes                     # [lanes, ht]
    hcols = torch.where(jh < head[:, None, None], jh, -1)
    tcols = torch.where(jh < (v - tail0)[:, None, None],
                        tail0[:, None, None] + jh, -1)
    cols = torch.cat([hcols, vcols, tcols], 2)
    ok = cols >= 0                                            # [n, lanes, E]
    flat = cols.flatten(1) % (v + 1)                          # -1 -> v
    seen = torch.zeros((n, v + 1), dtype=torch.int32, device=dev)
    seen.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    assert bool((seen[:, :v] == 1).all()), "a row's elements not one a lane"
    mx = x.amax(1)
    l2e = torch.tensor(LOG2E, device=dev)                 # log2 e in f32
    sh = x.gather(1, cols.clamp_min(0).flatten(1)).view(cols.shape) \
        - mx[:, None, None]
    e = torch.where(ok, torch.exp2(sh * l2e), 0.0)
    sh = torch.where(ok, sh, 0.0)
    s_lane = torch.zeros((n, lanes), device=dev)
    u_lane = torch.zeros((n, lanes), device=dev)
    for i in range(cols.shape[2]):
        s_lane = s_lane + e[:, :, i]
        u_lane = (u_lane.double() + e[:, :, i].double()
                  * sh[:, :, i].double()).float()
    off = lanes // 2
    while off:
        s_lane = s_lane + s_lane[:, j ^ off]
        u_lane = u_lane + u_lane[:, j ^ off]
        off //= 2
    s_row, u_row = s_lane[:, 0], u_lane[:, 0]
    lse = torch.log(s_row)
    ent = lse - u_row / s_row
    hit = (targets >= 0) & (targets < v)
    ts = torch.where(hit, x.gather(1, targets.long().clamp(0, v - 1)[:, None])
                     [:, 0] - mx, 0.0)
    # sigma as an f32 tensor: a division by a Python scalar multiplies by
    # its reciprocal, one ulp off the kernel's divide
    sig = torch.tensor(sigma, dtype=torch.float32, device=dev)
    lr = (ts - lse) - logp_old
    ratio = torch.exp(lr)
    z = lr / sig
    omega = torch.exp(-0.5 * (z * z))
    pg = -(omega * ratio * advantages)
    m = mask
    cols8 = torch.stack([pg * m, ratio * m, omega * m, m, ent * m,
                         (torch.expm1(-lr) + lr) * m,
                         (lr.abs() > 2.0 * sig).float() * m,
                         torch.zeros_like(m)], 1)
    nblk = -(-n // block_rows)
    cols8 = torch.cat([cols8, cols8.new_zeros((nblk * block_rows - n, 8))])
    cols8 = cols8.view(nblk, block_rows, 8)
    partials = torch.zeros((nblk, 8), device=dev)
    for r in range(block_rows):
        partials = partials + cols8[:, r]
    g = (coefs[0] * pg + coefs[1] * (1.0 - torch.exp(-lr))) * m
    ce = coefs[2] * m
    p = torch.exp2((x - mx[:, None]) * l2e) * (1.0 / s_row)[:, None]
    onehot = (torch.arange(v, device=dev) == targets.long()[:, None]).float()
    d = g[:, None] * (onehot - p) + ce[:, None] * (
        -(p * (((x - mx[:, None]) - lse[:, None]) + ent[:, None])))
    return partials, torch.where(m[:, None] == 0, 0.0, d)


def reference_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stepwise SSD recurrence oracle (the "linear form" of SSD duality),
    as the reference's ``repro/kernels/ref.py::reference_ssd``.

    x: [B,T,H,P]; dt: [B,T,H] (post-softplus); A: [H] (negative);
    Bm/Cm: [B,T,N]. Returns (y [B,T,H,P] f32, final state [B,H,P,N] f32).
    """
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for i in range(t):
        da = torch.exp(dt[:, i].float() * A.float()[None, :])       # [B,H]
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, i].float(),
                           x[:, i].float(), Bm[:, i].float())
        state = da[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, i].float()))
    return torch.stack(ys, dim=1), state


def split_bf16(v: torch.Tensor, terms: int) -> List[torch.Tensor]:
    """f32 ``v`` as ``terms`` bf16 values (returned in f32) whose sum
    approximates it: hi = bf16(v), then each next term the bf16 of what the
    terms before it leave. One term keeps ~8 bits of v, two ~16, three ~24
    (f32's precision): how the tensor-core bodies feed an f32 operand to
    bf16 products."""
    out, rest = [], v.float()
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def tiled_ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int, *,
                   terms: int = 3, return_states: bool = False):
    """The SSD scan in the order of arithmetic of K6's tensor-core body
    (``csrc/ssd_scan.cu``, ``ssd_fwd_tc_kernel``), in f32.

    Per chunk (the kernels' chunk: ``chunk``, or T rounded up to 32 when
    shorter; missing rows are zero steps) and per 16-row block i of y:
    C_i . S^T with S split into ``terms`` bf16 terms, scaled by exp(cum_i),
    then for each 16-column tile j <= i in order, W = (C_i . B_j^T) o G o
    dt_j (masked before the exponential) split into ``terms`` terms against
    the exact x_j. The state then takes exp(ct) S + (x o din)^T . B with
    x o din split likewise. Every product is of bf16 values, so exact in
    f32; the sums are f32. x, B, C are used as given (bf16 on the main
    paths, where they are exact). Returns (y [B,T,H,P], final state
    [B,H,P,N][, entering states [B,NC,H,P,N]]), all f32."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, -(-t // 32) * 32)
    nc = -(-t // q)

    def chunks(v):
        v = v.float()
        if nc * q > t:
            v = torch.cat([v, v.new_zeros((b, nc * q - t, *v.shape[2:]))], 1)
        return v.reshape(b, nc, q, *v.shape[2:])
    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    cum = torch.cumsum(dtc * A.float(), dim=2)               # [b,nc,q,h]
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys, enter = [], []
    for c in range(nc):
        enter.append(s)
        s_terms = split_bf16(s, terms)
        cum_c, ct = cum[:, c], cum[:, c, -1]                  # [b,q,h], [b,h]
        y = torch.zeros((b, q, h, p), dtype=torch.float32, device=x.device)
        for i0 in range(0, q, 16):
            ci = cc[:, c, i0:i0 + 16]
            acc = torch.zeros((b, 16, h, p), dtype=torch.float32,
                              device=x.device)
            for st in s_terms:
                acc = acc + torch.einsum("bin,bhpn->bihp", ci, st)
            acc = acc * torch.exp(cum_c[:, i0:i0 + 16])[..., None]
            for j0 in range(0, i0 + 16, 16):
                cb = torch.einsum("bin,bjn->bij", ci, bc[:, c, j0:j0 + 16])
                diff = (cum_c[:, i0:i0 + 16, None, :]
                        - cum_c[:, None, j0:j0 + 16, :])      # [b,i,j,h]
                ii = torch.arange(i0, i0 + 16, device=x.device)[:, None]
                jj = torch.arange(j0, j0 + 16, device=x.device)[None, :]
                g = torch.exp(diff.masked_fill(~(jj <= ii)[None, :, :, None],
                                               float("-inf")))
                w = cb[..., None] * g * dtc[:, c, None, j0:j0 + 16, :]
                for wt in split_bf16(w, terms):
                    acc = acc + torch.einsum("bijh,bjhp->bihp", wt,
                                             xc[:, c, j0:j0 + 16])
            y[:, i0:i0 + 16] = acc
        ys.append(y)
        din = torch.exp(ct[:, None, :] - cum_c) * dtc[:, c]   # [b,q,h]
        upd = torch.zeros_like(s)
        for xt in split_bf16(xc[:, c] * din[..., None], terms):
            upd = upd + torch.einsum("bjhp,bjn->bhpn", xt, bc[:, c])
        s = torch.exp(ct)[:, :, None, None] * s + upd
    y = torch.cat(ys, 1)[:, :t]
    return (y, s, torch.stack(enter, 1)) if return_states else (y, s)
