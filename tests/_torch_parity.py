"""Shared helpers of the ``test_torch_*`` files: carry data between the JAX
reference (``repro``) and the PyTorch port (``repro_torch``) as numpy arrays.

Both packages run on the CPU here.  Inputs and weights are made once (numpy,
or the reference's ``tree_init``), exported as float32 numpy arrays (exact for
bfloat16, which numpy lacks) and handed to both sides.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.param import from_reference

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, restored after it.  The tests'
    tensors are small; with several test workers on one machine, each
    worker's threads mostly wait on each other's (a test taking 7 s alone
    took 236 s beside five other workers).  Import it with
    ``pytestmark = pytest.mark.usefixtures("one_thread")``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_np(tree):
    """A JAX (or torch) tree as float32 / integer numpy arrays."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
        if jnp.issubdtype(x.dtype, jnp.floating):
            return np.asarray(x, np.float32)
        return np.asarray(x)
    return jax.tree.map(conv, tree)


def carry(tree, dtype=None):
    """Reference tree -> port tree on the CPU, float leaves cast to ``dtype``."""
    return from_reference(to_np(tree), dtype, "cpu")


def rand(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(a, dtype: str):
    """One numpy array as (jax array, torch tensor) of the named float type."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def max_err(port, ref) -> float:
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.max(np.abs(p - r))) if p.size else 0.0


BF16_ULP = 2.0 ** -7     # one bf16 ulp of l is at most 2^-7 |l|


def routing_margin_ulps(logits, k: int) -> float:
    """Smallest gap between neighbouring choices among the top k + 1 router
    logits of any token (the order of the top k, and the k-th against the
    next), in bf16 ulps of the larger of the two.  Below a few ulps, two
    frameworks that round the bf16 logits apart may route the token apart."""
    top = -np.sort(-np.asarray(to_np(logits), np.float64), axis=-1)[..., :k + 1]
    gaps = (top[..., :-1] - top[..., 1:]) / (BF16_ULP * np.abs(top[..., :-1]))
    return float(gaps.min())


@contextlib.contextmanager
def routing_margins():
    """Collects ``routing_margin_ulps`` of every routing the port's MoE
    layers do inside the block (a list, one entry a layer call)."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recording(x, router, cfg, **kw):
        seen.append(routing_margin_ulps((x @ router).float(), cfg.topk))
        return route(x, router, cfg, **kw)

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


@contextlib.contextmanager
def reference_scan(kernel: bool):
    """With ``kernel``, the reference's ``mamba2_apply`` runs its prefill scan
    through its own Pallas ``ssd_scan`` (interpret mode on the CPU) in place
    of its model twin ``ssd_chunked``: fp32 inside, as the port's kernel
    path, where the twin rounds ``att`` and the carried state to the inputs'
    type.  The port's kernel path is held against that reference."""
    import repro.models.mamba2 as RM
    from repro.kernels import ops

    twin = RM.ssd_chunked
    if kernel:
        RM.ssd_chunked = lambda xh, log_l, Bm, Cm, chunk, h0=None, unroll=False: ops.ssd_scan(
            xh, log_l, Bm, Cm, chunk=chunk)
    try:
        yield
    finally:
        RM.ssd_chunked = twin


def reference_scan_inputs(p, x, cfg):
    """The reference's ``mamba2_apply`` up to the scan (mamba2.py:146-162),
    which it computes and does not return: the conv input, and the scan's
    xdt, log_l, Bm, Cm."""
    import repro.models.mamba2 as RM

    DI, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    zxbcdt = jnp.einsum("bsd,dp->bsp", x, p["in_proj"])
    _, xc, Bm, Cm, dt = jnp.split(zxbcdt, [DI, 2 * DI, 2 * DI + N, 2 * DI + 2 * N], axis=-1)
    conv_in = jnp.concatenate([xc, Bm, Cm], axis=-1)
    conv_out = jax.nn.silu(RM._causal_conv(conv_in, p["conv_w"], p["conv_b"])[0])
    xc, Bm, Cm = jnp.split(conv_out, [DI, DI + N], axis=-1)
    dt = jax.nn.softplus(dt.astype(jnp.float32) + p["dt_bias"])
    log_l = dt * -jnp.exp(p["A_log"].astype(jnp.float32))
    xh = xc.reshape(x.shape[0], x.shape[1], H, P)
    return conv_in, (xh * dt[..., None].astype(xh.dtype), log_l, Bm, Cm)


def draw_time_mix(tm, cm, rng):
    """An RWKV-6 layer's leaves that the reference initialises to zeros,
    drawn non-zero in place (numpy trees, stacked or not): the token-shift
    mixes ``mu`` ~ U(0, 1) of the time-mix ``tm`` and channel-mix ``cm``, the
    decay's bias ``w0`` ~ randn - 1 and the bonus ``bonus_u`` ~ 0.3 randn.
    With zeros the token shift, the bonus and the decay's bias do nothing, so
    a parity test could not see them wrong."""
    for p in (tm, cm):
        p["mu"] = rng.uniform(0.0, 1.0, p["mu"].shape).astype(np.float32)
    tm["w0"] = (rng.standard_normal(tm["w0"].shape) - 1.0).astype(np.float32)
    tm["bonus_u"] = (0.3 * rng.standard_normal(tm["bonus_u"].shape)).astype(np.float32)


@contextlib.contextmanager
def reference_rwkv_scan(kernel: bool):
    """With ``kernel``, the reference's ``timemix_apply`` runs its prefill
    scan through its own Pallas ``rwkv6_scan`` (interpret mode on the CPU) in
    place of its model twin ``rwkv6_chunked``.  The port's kernel path is
    held against that reference as well as against the twin."""
    import repro.models.rwkv6 as RW
    from repro.kernels import ops

    twin = RW.rwkv6_chunked
    if kernel:
        RW.rwkv6_chunked = lambda r, k, v, w, u, chunk, s0=None, unroll=False: ops.rwkv6_scan(
            r, k, v, w, u, chunk=chunk)
    try:
        yield
    finally:
        RW.rwkv6_chunked = twin


def reference_rwkv_scan_inputs(p, x, cfg):
    """The reference's ``timemix_apply`` up to the scan (rwkv6.py:172-191),
    which it computes and does not return: r, k, v, w as (B,S,H,N) and u."""
    import repro.models.rwkv6 as RW

    B, S, _ = x.shape
    H, N = cfg.n_heads, cfg.head_dim
    xprev = RW._token_shift(x, None)
    mu = p["mu"]
    r, k, v = (jnp.einsum("bsd,de->bse", RW._lerp(x, xprev, mu[i]), p[n])
               for i, n in enumerate(("wr", "wk", "wv")))
    xw = RW._lerp(x, xprev, mu[4])
    wlog = p["w0"][None, None] + jnp.einsum("bsd,dl,le->bse", xw, p["w_lora_a"], p["w_lora_b"])
    w = jnp.exp(-jnp.exp(wlog.astype(jnp.float32)))
    return tuple(t.reshape(B, S, H, N) for t in (r, k, v, w)) + (p["bonus_u"].reshape(H, N),)


def flash_emulated(q, k, v, *, causal=True, window=None, prefix_len=0, q_start=0,
                   sm_scale=None, p_parts=2, splits=1, tile=64, col_block=None):
    """The arithmetic of the port's CUDA flash-attention kernels, in PyTorch
    on the CPU: fp32 scores of the bf16 inputs, 64-key tiles with the online
    softmax (finite -1e30 fill), and O += P.V in fp32 with P cut into
    ``p_parts`` bf16 pieces (2: the tensor-core kernel's P_hi + P_lo; 1: a
    single bf16 P; None: P kept in fp32, as the decode kernel keeps it).  The
    key tiles are cut into ``splits`` ranges whose partials (acc, m, l) are
    combined in split order, as the decode kernels do.  ``col_block`` takes
    the output's columns that many at a time, each block with its own scores
    and softmax: the tensor-core kernel's two warpgroups at head_dim 256 (128
    columns each, both computing the same S and P)."""
    D = q.shape[4]
    if col_block is not None and col_block < D:
        kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_start=q_start,
                  sm_scale=sm_scale if sm_scale is not None else 1.0 / D ** 0.5,
                  p_parts=p_parts, splits=splits, tile=tile)
        return torch.cat([flash_emulated(q, k, v[..., c:c + col_block], **kw)
                          for c in range(0, D, col_block)], dim=-1)
    from repro_torch.kernels.flash_attention import NEG_INF, visible

    Sq, Sk = q.shape[3], k.shape[2]
    Dv = v.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / D ** 0.5
    ok = visible(Sq, Sk, causal=causal, window=window, prefix_len=prefix_len, q_start=q_start)
    s_all = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float()) * scale
    s_all = torch.where(ok, s_all, torch.full_like(s_all, NEG_INF))
    vf = v.float()[:, :, None]
    n_tiles = -(-Sk // tile)
    per = -(-n_tiles // splits)
    parts = []
    for sp in range(splits):
        m = torch.full(s_all.shape[:-1], NEG_INF)
        l = torch.zeros(s_all.shape[:-1])
        acc = torch.zeros(*s_all.shape[:-1], Dv)
        for j in range(sp * per, min(n_tiles, (sp + 1) * per)):
            keys = slice(j * tile, (j + 1) * tile)
            s = s_all[..., keys]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            if p_parts is None:
                acc = acc + p @ vf[..., keys, :]
            else:
                rest = p
                for _ in range(p_parts):
                    piece = rest.bfloat16().float()
                    acc = acc + piece @ vf[..., keys, :]
                    rest = rest - piece
            m = m_new
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        O = O + acc * w[..., None]
    return (O / L.clamp_min(1e-20)[..., None]).to(q.dtype)


def flash_bwd_emulated(q, k, v, o, lse, do, *, causal=True, window=None, prefix_len=0, q_start=0):
    """The arithmetic of the port's CUDA flash-attention backward kernels, in
    PyTorch on the CPU: fp32 scores of the bf16 inputs, P from the saved
    log-sum-exp, delta from ``o`` as given (the kernels': the forward's
    output before its rounding, fp32), dS in fp32; P rounded to bf16
    as the dV product's operand, dS cut into two bf16 pieces (the kernels'
    dS_hi + dS_lo) as the dK and dQ products', whose sums are fp32; (dq, dk,
    dv) rounded once to bf16."""
    from repro_torch.kernels.flash_attention import visible

    D = q.shape[4]
    scale = 1.0 / D ** 0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    ok = visible(q.shape[3], k.shape[2], causal=causal, window=window, prefix_len=prefix_len, q_start=q_start)
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = sum(split_parts(p * (dp - (dof * of).sum(-1)[..., None]), 2, "bf16"))
    p = p.bfloat16().float()
    return (torch.einsum("bkgqs,bksd->bkgqd", ds, kf).mul(scale).to(q.dtype),
            torch.einsum("bkgqs,bkgqd->bksd", ds, qf).mul(scale).to(k.dtype),
            torch.einsum("bkgqs,bkgqd->bksd", p, dof).to(v.dtype))


def tf32_cut(v: torch.Tensor) -> torch.Tensor:
    """fp32 cut toward zero to TF32 (10 explicit mantissa bits): the low 13
    bits cleared, as the kernel masks them."""
    return (v.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_parts(v: torch.Tensor, parts: int, kind: str) -> list[torch.Tensor]:
    """v as ``parts`` pieces of type ``kind`` ("tf32": cut toward zero;
    "bf16": rounded to nearest), each taken from what the pieces before it
    leave: v = sum(pieces) + residual."""
    pieces, rest = [], v.float()
    for _ in range(parts):
        piece = tf32_cut(rest) if kind == "tf32" else rest.bfloat16().float()
        pieces.append(piece)
        rest = rest - piece
    return pieces


def ssd_emulated(xh, log_l, Bm, Cm, *, chunk=128, h0=None, parts=2, kind="tf32", p_block=64):
    """The arithmetic of the port's bf16 SSD-scan kernel (``tc::`` in
    ``csrc/ssd_scan.cu``), in PyTorch on the CPU.  Per chunk of Q rows,
    staged as a multiple of 16 rows with zero rows (x = 0, B = 0, log_l = 0)
    past the sequence: the cumulative log decay in float64; the scores
    S = C B^T once per batch row and chunk, in fp32, shared by every head;
    att = S * exp(cum_i - cum_j), the difference narrowed to fp32 after it is
    taken and masked before the exponential; then the three products with the
    operand held in fp32 (att, the state h, B * tail) cut into ``parts``
    pieces of ``kind`` ("tf32": the kernel's two TF32 parts; "bf16": one or
    two bf16 parts, the alternatives it was chosen over) against the bf16
    operand, each piece's product summed in fp32.  The columns of P are taken
    ``p_block`` at a time (the kernel's block takes all of them, P <= 64; a
    smaller block shows that a split of P changes nothing)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    ys, hs = [], []
    for p0 in range(0, P, p_block):
        x = xh[..., p0:p0 + p_block].float()
        h = (torch.zeros((B, H, x.shape[-1], N)) if h0 is None else h0[:, :, p0:p0 + p_block].float())
        y_cols = []
        for s0 in range(0, S, Q):
            q = min(Q, S - s0)
            qp = -(-q // 16) * 16
            pad = lambda t: torch.cat([t, t.new_zeros((B, qp - q, *t.shape[2:]))], dim=1)  # noqa: E731
            xq, lq = pad(x[:, s0:s0 + q]), pad(log_l[:, s0:s0 + q].float())
            bq, cq = pad(Bm[:, s0:s0 + q].float()), pad(Cm[:, s0:s0 + q].float())
            cum = torch.cumsum(lq.double(), dim=1)                       # (B,qp,H)
            scores = torch.einsum("bin,bjn->bij", cq, bq)                # once, all heads
            diff = cum[:, :, None, :] - cum[:, None, :, :]               # (B,i,j,H)
            causal = torch.tril(torch.ones((qp, qp), dtype=torch.bool))[None, :, :, None]
            att = scores[..., None] * torch.exp(torch.where(causal, diff, -torch.inf).float())
            y = sum(torch.einsum("bijh,bjhp->bihp", a, xq) for a in split_parts(att, parts, kind))
            inter = sum(torch.einsum("bin,bhpn->bihp", cq, hp) for hp in split_parts(h, parts, kind))
            y = inter * torch.exp(cum.float())[..., None] + y
            y_cols.append(y[:, :q])
            last = cum[:, -1:, :]
            bt = bq[:, :, None, :] * torch.exp((last - cum).float())[..., None]    # (B,qp,H,N)
            dh = sum(torch.einsum("bjhp,bjhn->bhpn", xq, a) for a in split_parts(bt, parts, kind))
            h = h * torch.exp(last[:, 0].float())[:, :, None, None] + dh
        ys.append(torch.cat(y_cols, dim=1))
        hs.append(h)
    return torch.cat(ys, dim=-1).to(xh.dtype), torch.cat(hs, dim=2)


def moe_compacted(disp, x, *, buffer=256):
    """The arithmetic of the port's MoE-dispatch kernel, in PyTorch on the
    CPU: for each (expert, batch row, slot) the list of its nonzero weights
    (t, w) in ascending t, built ``buffer`` tokens at a time when the slot
    holds more than ``buffer`` (the kernel's token ranges), and the output row
    as an fp32 sum over the list in that order (each multiply-add rounded
    once, as ``fmaf`` rounds); a slot with an empty list is zeros.  disp
    (B,T,E,C), x (B,T,D) -> (E,B,C,D) in x's type."""
    B, T, E, C = disp.shape
    w_all, xf = disp.float(), x.float()
    out = torch.zeros((E, B, C, x.shape[-1]), dtype=torch.float64)
    for b in range(B):
        for e in range(E):
            for c in range(C):
                col = w_all[b, :, e, c]
                ranges = [(0, T)] if int((col != 0).sum()) <= buffer else \
                    [(r0, min(T, r0 + buffer)) for r0 in range(0, T, buffer)]
                acc = torch.zeros(x.shape[-1], dtype=torch.float64)
                for r0, r1 in ranges:
                    for t in (torch.nonzero(col[r0:r1]).flatten() + r0).tolist():
                        # w x + acc exact in float64, then one rounding to fp32
                        acc = (col[t].double() * xf[b, t].double() + acc).float().double()
                out[e, b, c] = acc
    return out.to(x.dtype)


def _split_product(eq, a, b, parts, kind, terms):
    """einsum ``eq`` of two fp32 operands, each cut into ``parts`` pieces of
    ``kind``, summing the ``terms`` largest piece products in fp32: (0, 0),
    (0, 1), (1, 0), ... (for two parts, 3 drops small x small; 2 drops small x
    big as well, leaving a's small part out)."""
    pa, pb = split_parts(a, parts, kind), split_parts(b, parts, kind)
    pairs = sorted(((i, j) for i in range(parts) for j in range(parts)), key=lambda p: (p[0] + p[1], p[0]))
    return sum(torch.einsum(eq, pa[i], pb[j]) for i, j in pairs[:terms])


def rwkv_emulated(r, k, v, w, u, *, chunk=128, s0=None, parts=2, kind="tf32", terms=3, seen=None):
    """The arithmetic of the port's bf16 RWKV-6 scan kernel (``tc::`` in
    ``csrc/rwkv6_scan.cu``), in PyTorch on the CPU.  Per chunk of Q rows,
    staged as a multiple of 16 rows with zero rows (r = k = v = 0, l = 0)
    past the sequence, and per 16-row tile t:

    - l = log2(clip(w, 1e-6, 1)) in fp32; its running sum from the tile's
      first row in float64, narrowed to fp32: c_j = cum_j - R_t <= 0; the
      tile totals in float64, and every decay between tile edges (R_ti -
      R_tj+1, R_t, R_last - R_t+1, R_last) summed from them in float64;
    - the row scales r'_i = r_i 2^(c_i-1) (0 at a tile's first row) and
      k'_j = k_j 2^(c_last - c_j), and from them the edge decays r_i
      2^(cum_i-1) = r'_i 2^(R_t) and k_j 2^(cum_last - cum_j) = k'_j
      2^(R_last - R_t+1);
    - scores of an off-diagonal tile pair (ti > tj) as the product of r' and
      k' 2^(R_ti - R_tj+1), every factor <= 1; on a diagonal tile the direct
      form sum_n r_i k_j 2^(c_i-1 - c_j) for j < i only (the mask taken
      before the exponential) and the bonus sum_n r_i u k_i on the diagonal,
      in fp32;
    - y = att v + (r 2^(cum_i-1)) S and S <- S 2^(R_last) + (k 2^(cum_last -
      cum_j))^T v, each product's fp32 operands cut into ``parts`` pieces of
      ``kind`` (v, bf16, is exact in either), ``terms`` piece products kept
      where both operands are fp32 (scores and r S).

    l is taken exactly here; the kernel takes it from the MUFU's lg2
    (``__log2f``, about 2^-22 of error), which the card's checks cover.
    ``seen``, a list, collects the largest exponent of every ex2 taken."""
    B, S, H, N = r.shape
    Q = min(chunk, S)

    def ex2(x):
        if seen is not None and x.numel():
            seen.append(float(x.max()))
        return torch.exp2(x)

    def prod(eq, a, b):
        return _split_product(eq, a, b, parts, kind, terms)

    def by_v(eq, a, vv):
        return sum(torch.einsum(eq, piece, vv) for piece in split_parts(a, parts, kind))

    rf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (r, k, v))           # (B,H,S,N)
    lf = torch.log2(torch.clamp(w.float(), 1e-6, 1.0)).permute(0, 2, 1, 3)
    uf = u.float()[None, :, None, :]
    st = torch.zeros((B, H, N, N)) if s0 is None else s0.float().clone()
    ys = []
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        qp = -(-q // 16) * 16
        nt = qp // 16
        pad = lambda t: torch.cat([t[:, :, c0:c0 + q], t.new_zeros((B, H, qp - q, N))], dim=2)  # noqa: E731
        rq, kq, vq, lq = pad(rf), pad(kf), pad(vf), pad(lf)
        run = lq.double().reshape(B, H, nt, 16, N).cumsum(3)
        c = run.float()                                                  # (B,H,nt,16,N)
        tot = run[:, :, :, -1]                                           # (B,H,nt,N) fp64
        cprev = torch.cat([torch.zeros_like(c[:, :, :, :1]), c[:, :, :, :-1]], dim=3)
        rs = (rq.reshape(B, H, nt, 16, N) * ex2(cprev))
        ks = (kq.reshape(B, H, nt, 16, N) * ex2(c[:, :, :, -1:] - c))
        before = torch.stack([tot[:, :, :t].sum(2) for t in range(nt)], dim=2)          # R_t
        after = torch.stack([tot[:, :, t + 1:].sum(2) for t in range(nt)], dim=2)       # R_last - R_t+1
        ri = (rs * ex2(before.float())[:, :, :, None]).reshape(B, H, qp, N)
        kk = (ks * ex2(after.float())[:, :, :, None]).reshape(B, H, qp, N)
        decay = ex2(tot.sum(2).float())                                  # (B,H,N)
        att = torch.zeros((B, H, qp, qp))
        lower = torch.tril(torch.ones((16, 16), dtype=torch.bool), diagonal=-1)[:, :, None]
        for ti in range(nt):
            rows = slice(16 * ti, 16 * ti + 16)
            if ti:
                mid = torch.stack([tot[:, :, tj + 1:ti].sum(2) for tj in range(ti)], dim=2)  # (B,H,ti,N)
                kb = (ks[:, :, :ti] * ex2(mid.float())[:, :, :, None]).reshape(B, H, 16 * ti, N)
                att[:, :, rows, :16 * ti] = prod("bhin,bhjn->bhij", rs[:, :, ti], kb)
            d = cprev[:, :, ti][:, :, :, None] - c[:, :, ti][:, :, None]                   # (B,H,i,j,N)
            e = ex2(torch.where(lower, d, -torch.inf))
            diag = (rq[:, :, rows, None] * kq[:, :, None, rows] * e).sum(-1)
            bonus = (rq[:, :, rows] * uf * kq[:, :, rows]).sum(-1)
            att[:, :, rows, rows] = diag + torch.diag_embed(bonus)
        y = prod("bhin,bhnm->bhim", ri, st) + by_v("bhij,bhjm->bhim", att, vq)
        ys.append(y[:, :, :q])
        st = st * decay[..., None] + by_v("bhjn,bhjm->bhnm", kk, vq)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(r.dtype), st
