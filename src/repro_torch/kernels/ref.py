"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``): what a CPU tensor runs, and what the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_dense, attn_paged, attn_tree
from repro_torch.models.ssm import ssd_chunked


def int8_matmul_ref(x_q, w_q, sx, sw, out_dtype=torch.bfloat16):
    """[M,K]i8 @ [K,N]i8 with exact int32 accumulation, then the rescale
    ``acc * sx * sw[n]`` in fp32 (in that order), then the cast. A CUDA
    tensor sums in float64, which is exact here (|sum| <= K * 2**14 <
    2**53): the card has no plain int32 matmul."""
    if x_q.device.type == "cpu":
        acc = x_q.to(torch.int32) @ w_q.to(torch.int32)
    else:
        acc = (x_q.double() @ w_q.double()).to(torch.int32)
    return (acc.float() * sx * sw[None, :]).to(out_dtype)


def blockwise_argmax_ref(logits):
    """[R, V] -> int32 [R, 1]; the first maximum wins, as in the kernel."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def flash_attention_ref(q, k, v, *, window=None, causal=True, s_valid=None):
    """The model-level dense attention with query and key positions both
    counted from 0; keys at or past ``s_valid`` carry position -1, which
    ``_mask`` never shows."""
    Sq, Skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(Sq, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    if s_valid is not None:
        kv_pos = torch.where(kv_pos < s_valid, kv_pos, -1)
    return attn_dense(q, k, v, q_pos, kv_pos, window=window, causal=causal)


def paged_attention_ref(q, k_pool, v_pool, block_table, index, *,
                        window=None, scale=None, max_live=None):
    """The model-level block-scan paged attention."""
    return attn_paged(q, k_pool, v_pool, block_table, index, window=window,
                      scale=scale, max_live=max_live)


def tree_attention_ref(q, k_pool, v_pool, block_table, index, depths, bits,
                       *, window=None, scale=None, max_live=None):
    """The model-level block-scan tree attention."""
    return attn_tree(q, k_pool, v_pool, block_table, index, depths, bits,
                     window=window, scale=scale, max_live=max_live)


def live_keys(index, Q, BS, MB, max_live=None):
    """[B] keys each row's paged walk covers, as the kernels compute it:
    whole pages, min(ceil((index + Q) / BS), ceil(max_live / BS)), at least
    one page and at most the table's MB."""
    idx = torch.as_tensor(index, dtype=torch.int64)
    pages = torch.clamp((idx + Q + BS - 1) // BS, 1, MB)
    if max_live is not None:
        cap = min(max((int(max_live) + BS - 1) // BS, 1), MB)
        pages = torch.clamp(pages, max=cap)
    return pages * BS


def paged_split_ref(q, k_pool, v_pool, block_table, index, *, depths=None,
                    bits=None, window=None, max_live=None, chunk=64,
                    p_bf16=False):
    """The split computation of the bf16 paged / tree kernels in plain
    PyTorch (fp32): each row's keys go in fixed chunks of ``chunk`` keys
    counted from key 0; each chunk gives a partial (max m, sum l, weighted
    values acc) of its own, and the partials are merged in chunk order with
    weights exp(m_c - M), exactly 1 where m_c is the row's max M. Keys past
    the row's ``live_keys`` are masked; ``depths``/``bits`` select the tree
    policy (``_tree_mask``), else causal. ``p_bf16`` rounds the weights to
    bf16 before the value product, as the kernel's tensor cores take them.

    Each (query row, chunk) is computed on its own, with tensors whose
    shapes depend on neither Q nor the chunk count, so a row's result does
    not depend on the call's Q (the property the kernel keeps)."""
    from repro_torch.models.attention import NEG_INF, _mask, _tree_mask
    B, Q, H, D = q.shape
    BS, Kv = k_pool.shape[1], k_pool.shape[2]
    MB = block_table.shape[1]
    G = H // Kv
    dev = q.device
    idx = torch.as_tensor(index, dtype=torch.int32).to(dev)
    if idx.ndim == 0:
        idx = idx.expand(B)
    live = live_keys(idx.cpu(), Q, BS, MB, max_live).to(dev)          # [B]
    n_chunks = -(-int(live.max()) // chunk)
    S = n_chunks * chunk
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)
    if depths is None:
        q_pos = idx[:, None] + torch.arange(Q, dtype=torch.int32, device=dev)
        vis = _mask(q_pos, kv_pos, window)                            # [B, Q, S]
    else:
        depths = torch.as_tensor(depths, dtype=torch.int32).to(dev)
        bits = torch.as_tensor(bits, dtype=torch.int32).to(dev)
        vis = _tree_mask(idx, kv_pos, depths, bits, window)
    vis = vis & (kv_pos[None, None, :] < live[:, None, None])
    # the keys through the block table (past the table: its last key,
    # masked like every key past the live bound)
    cols = torch.clamp(kv_pos.long(), max=MB * BS - 1)
    blk = torch.clamp(block_table.long()[:, cols // BS], 0, k_pool.shape[0] - 1)
    kf = k_pool[blk, cols % BS].float()                               # [B, S, Kv, D]
    vf = v_pool[blk, cols % BS].float()
    kc = kf.permute(0, 2, 1, 3).reshape(B, Kv, 1, n_chunks, chunk, D)
    vc = vf.permute(0, 2, 3, 1).reshape(B, Kv, 1, D, n_chunks, chunk)
    scale = D ** -0.5
    out = torch.empty((B, Q, H, D), dtype=q.dtype, device=dev)
    for qi in range(Q):
        qr = q[:, qi].float().reshape(B, Kv, G, 1, D)
        parts = []
        for c in range(n_chunks):
            s = (qr * kc[:, :, :, c]).sum(-1) * scale       # [B, Kv, G, chunk]
            v_row = vis[:, qi, c * chunk:(c + 1) * chunk].reshape(B, 1, 1, chunk)
            s = torch.where(v_row, s, torch.full_like(s, NEG_INF))
            m = s.amax(dim=-1)                              # [B, Kv, G]
            p = torch.exp(s - m[..., None])
            l_c = p.sum(-1)
            if p_bf16:
                p = p.to(torch.bfloat16).float()
            acc = (p[..., None, :] * vc[:, :, :, :, c]).sum(-1)   # [B, Kv, G, D]
            parts.append((m, l_c, acc))
        M = parts[0][0]
        for m, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        L = torch.zeros_like(M)
        A = torch.zeros((B, Kv, G, D), dtype=torch.float32, device=dev)
        for m, l_c, acc in parts:                           # in chunk order
            w = torch.where(m == M, torch.ones_like(M), torch.exp(m - M))
            L = L + w * l_c
            A = A + w[..., None] * acc
        o = A / torch.clamp(L, min=1e-30)[..., None]
        out[:, qi] = o.reshape(B, H, D).to(q.dtype)
    return out


def ssd_scan_ref(x, dA, Bm, Cm, chunk=128):
    """The model-level chunked SSD from a zero state, y only (any l: the
    tail is zero-padded to a chunk multiple and cut off again)."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    init = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y, _ = ssd_chunked(x.float(), dA.float(), Bm.float(), Cm.float(), chunk, init)
    return y


def ssd_split_ref(x, dA, Bm, Cm, chunk=128, plan=None):
    """The SSD scan kernel's decomposition in plain PyTorch (fp32), item by
    item of ``plan`` (``kernels/ssd_scan.py::plan``; by default the plan on
    132 SMs): each y item forms the causal score tile C_i . B_j of its
    16-row tile from its group's first head, applies each head's decay
    (selected to 0 above the diagonal and past the real rows) and
    multiplies by the head's X; each state item forms its columns of a chunk's contribution
    (X o exp(a_cs[Q-1] - a_cs))^T B; then, per (batch row, head) and
    64-row tile, the state is carried over the chunks in order
    (state' = exp(a_cs[Q-1]) state + contribution) and exp(a_cs) o (C
    state^T) is added to y_diag. Chunks are zero-padded to whole 16-row
    tiles, and every product of a full chunk has shapes that depend on the
    chunk length alone, so a row's result does not depend on l (the
    property the kernel keeps). The sums run in PyTorch's order, not the
    kernel's FFMA order."""
    from repro_torch.kernels import ssd_scan as ss
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    if plan is None:
        plan = ss.plan(b, l, h, p, n, chunk, 132,
                       shared=ss.shares_scores(Bm, Cm))
    dev = x.device
    Q, nc, RT = chunk, plan.chunks, ss.ROW_TILE
    R = -(-Q // RT) * RT                       # a chunk padded to whole row tiles
    xf, af, bf, cf = (t.float() for t in (x, dA, Bm, Cm))

    def rows(t, c):
        """Chunk c of t ([b, l, ...]), its real rows then zeros up to R."""
        nv = min(Q, l - c * Q)
        out = torch.zeros((b, R) + tuple(t.shape[2:]), dtype=torch.float32, device=dev)
        out[:, :nv] = t[:, c * Q:c * Q + nv]
        return out

    X = [rows(xf, c) for c in range(nc)]
    Bc = [rows(bf, c) for c in range(nc)]
    Cc = [rows(cf, c) for c in range(nc)]
    acs = [torch.cumsum(rows(af, c), dim=1) for c in range(nc)]   # [b, R, h]
    y = torch.zeros((b, l, h, p), dtype=torch.float32, device=dev)
    ar = torch.arange(R, device=dev)
    for bb, h0, c, t in ss.y_items(plan, b, h, Q):
        nv = min(Q, l - c * Q)
        r0 = t * RT
        nr = min(RT, nv - r0)
        J = r0 + nr
        S = Cc[c][bb, r0:r0 + RT, h0] @ Bc[c][bb, :J, h0].T              # [RT, J]
        i, j = ar[r0:r0 + RT, None], ar[None, :J]
        vis = (j <= i) & (i < nv)
        for hd in range(h0, h0 + plan.heads):
            a = acs[c][bb, :, hd]
            Sp = torch.where(vis, S * torch.exp(a[r0:r0 + RT, None] - a[None, :J]),
                             torch.zeros((), device=dev))
            y[bb, c * Q + r0:c * Q + J, hd] = (Sp @ X[c][bb, :J, hd])[:nr]
    Z = torch.zeros((b, h, max(nc - 1, 0), n, p), dtype=torch.float32, device=dev)
    for bb, hd, c, k0 in ss.state_items(plan, b, h, n):
        a = acs[c][bb, :Q, hd]
        xd = X[c][bb, :Q, hd] * torch.exp(a[Q - 1] - a)[:, None]         # [Q, p]
        Z[bb, hd, c, k0:k0 + ss.K_TILE] = (xd.T @ Bc[c][bb, :Q, hd, k0:k0 + ss.K_TILE]).T
    CR = ss.CARRY_ROWS
    for bb in range(b):
        for hd in range(h):
            for r0 in range(0, R, CR):
                state = torch.zeros((n, p), dtype=torch.float32, device=dev)
                decay = torch.exp(acs[0][bb, Q - 1, hd])
                for c in range(1, nc):
                    nv = min(Q, l - c * Q)
                    state = decay * state + Z[bb, hd, c - 1]
                    decay = torch.exp(acs[c][bb, Q - 1, hd])
                    if r0 >= nv:
                        continue
                    Crows = torch.zeros((CR, n), dtype=torch.float32, device=dev)
                    m = min(CR, R - r0)
                    Crows[:m] = Cc[c][bb, r0:r0 + m, hd]
                    off = (Crows @ state)[:min(CR, nv - r0)]                  # [rows, p]
                    ea = torch.exp(acs[c][bb, r0:r0 + off.shape[0], hd])
                    t0 = c * Q + r0
                    y[bb, t0:t0 + off.shape[0], hd] += off * ea[:, None]
    return y
