"""Plain PyTorch versions of the port's CUDA kernels.

Each kernel in ``csrc/`` is held against the function here: the wrappers in
:mod:`repro_torch.kernels.ops` take these for tensors on the CPU (the parity
tests), and ``chip_smoke.py`` compares every kernel with its plain version on
the card. They repeat the kernels' arithmetic in the same order of
operations and are no yardstick of speed.
"""

from __future__ import annotations

import torch


def hw_scan_ref(y, alpha, gamma, init_seas):
    """Constrained-space Holt-Winters recurrence (see core/holt_winters.py).

    y: (N, T) > 0; alpha, gamma: (N,) in (0,1); init_seas: (N, M) > 0.
    Returns levels (N, T), seas (N, T+M)  [seas[:, t] = s_t applied to y_t].

    A bf16 y (the bf16 policy's stream) with float32 parameters: torch
    promotes each ``alpha * y_t`` and ``y_0 / s_0`` to float32, widening
    y_t exactly, so the ring, levels and seas stay in the parameters' dtype
    -- the reference kernel's contract and K1's arithmetic.
    """
    t_len = y.shape[1]
    ring = list(init_seas.unbind(1))          # ring[0] is the current s_t
    l_prev = y[:, 0] / ring[0]
    one_minus_a = 1.0 - alpha
    one_minus_g = 1.0 - gamma
    levels, seas_used = [], []
    for t in range(t_len):
        y_t = y[:, t]
        s_t = ring.pop(0)
        l_t = alpha * y_t / s_t + one_minus_a * l_prev
        ring.append(gamma * y_t / l_t + one_minus_g * s_t)
        levels.append(l_t)
        seas_used.append(s_t)
        l_prev = l_t
    return (torch.stack(levels, dim=1),
            torch.stack(seas_used + ring, dim=1))


def hw_scan_bwd_ref(y, alpha, gamma, levels, seas, dlev, dseas):
    """Adjoint of :func:`hw_scan_ref`, time-reversed (the plain K2).

    The recurrence of ``src/repro/kernels/hw_scan.py`` (module docstring and
    ``_hw_scan_bwd_kernel``), with ``lam_t`` the level cotangent and
    ``sig_t`` the seasonality cotangent, for t = T-1 .. 0:

        lam_t = dl_t + (1 - a) lam_{t+1} - sig_{t+m} g y_t / l_t^2
        sig_t = ds_t + (1 - g) sig_{t+m} - lam_t a y_t / s_t^2
        dy_t  = lam_t a / s_t + sig_{t+m} g / l_t
        da   += lam_t (y_t / s_t - l_{t-1});  dg += sig_{t+m} (y_t / l_t - s_t)

    The sigma ring is seeded with the trailing rows ``dseas[:, T..T+m-1]``
    and ends holding ``d init_seas``; the primer level ``l_{-1} = y_0 / s_0``
    adds ``(1 - a) lam_0 / s_0`` to ``dy_0`` and takes
    ``(1 - a) lam_0 y_0 / s_0^2`` off ring slot 0.

    y, levels, dlev: (N, T); alpha, gamma: (N,); seas, dseas: (N, T+m).
    Returns dy (N, T), dalpha (N,), dgamma (N,), d init_seas (N, m).

    A bf16 y (the bf16 policy's stream): torch promotes each product and
    quotient with y_t to float32, widening y_t exactly, so the state, the
    cotangents and dalpha, dgamma, d init_seas stay float32, and dy is
    rounded to bf16 once at the end -- the reference kernel's contract
    (``hw_scan.py:195-197``, ``:216``) and K2's arithmetic.
    """
    t_len = y.shape[1]
    m = seas.shape[1] - t_len
    one_minus_a = 1.0 - alpha
    one_minus_g = 1.0 - gamma
    s00 = seas[:, 0]
    y0 = y[:, 0]
    ring = [None] * m                         # slot t mod m holds sig_{t+m}
    for k in range(m):
        ring[(t_len + k) % m] = dseas[:, t_len + k]
    lam = torch.zeros_like(alpha)
    da = torch.zeros_like(alpha)
    dg = torch.zeros_like(alpha)
    dy = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        slot = t % m
        y_t, l_t, s_t = y[:, t], levels[:, t], seas[:, t]
        l_prev = levels[:, t - 1] if t > 0 else y0 / s00
        sig_tpm = ring[slot]
        lam = (dlev[:, t] + one_minus_a * lam
               - sig_tpm * gamma * y_t / (l_t * l_t))
        sig_t = (dseas[:, t] + one_minus_g * sig_tpm
                 - lam * alpha * y_t / (s_t * s_t))
        ring[slot] = sig_t
        dy_t = lam * alpha / s_t + sig_tpm * gamma / l_t
        if t == 0:
            dy_t = dy_t + one_minus_a * lam / s00
        dy[t] = dy_t
        da = da + lam * (y_t / s_t - l_prev)
        dg = dg + sig_tpm * (y_t / l_t - s_t)
    ring[0] = ring[0] - one_minus_a * lam * y0 / (s00 * s00)
    return (torch.stack(dy, dim=1).to(y.dtype), da, dg,
            torch.stack(ring, dim=1))


def widen(t):
    """``t`` in float32 if it is a narrower float (a bf16 stream), else as
    it is. A product of two widened bf16 values is exact in float32, so a
    matmul of widened operands accumulates in float32 -- what the reference
    asks with ``preferred_element_type=float32``. A bf16 matmul would round
    its output to bf16 instead, on the CPU and in cuBLAS alike."""
    return t.float() if t.is_floating_point() and t.element_size() < 4 else t


def lstm_cell_ref(wx, wh, b, x, h, c):
    """Fused LSTM cell. wx:(I,4H) wh:(H,4H) b:(4H,) x:(B,I) h,c:(B,H).

    Gate order (i, f, g, o). In bf16 (all six inputs) this is the reference
    kernel's contract (``src/repro/kernels/lstm_cell.py:48-69``): the
    inputs widened to float32, the gate sums, activations and state update
    in float32, h' and c' rounded to bf16 once (h' from the float32 c')."""
    out_dtype = x.dtype
    wx, wh, b, x, h, c = (widen(t) for t in (wx, wh, b, x, h, c))
    gates = x @ wx + h @ wh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(out_dtype), c_new.to(out_dtype)


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in bf16 units in the last
    place: how many bf16 values lie between them, counted across zero (the
    bit patterns ordered by value; +0 and -0 are one point). The bf16
    kernels are held to 1 against their plain versions."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def lstm_cell_fwd_ref(wx, wh, b, x, h, c):
    """The plain K4: :func:`lstm_cell_ref` that also returns the gate
    activations ``act = [sigmoid(i) | sigmoid(f) | tanh(g) | sigmoid(o)]``
    (B, 4H), the residual :func:`lstm_cell_bwd_ref` consumes.

    In bf16 it is :func:`lstm_cell_ref`'s contract, with ``act`` rounded to
    bf16 once as it is stored (the reference writes it in the stream dtype,
    ``src/repro/kernels/lstm_cell.py:87``); h' is taken from the float32
    activations and c', as in K3."""
    out_dtype = x.dtype
    wx, wh, b, x, h, c = (widen(t) for t in (wx, wh, b, x, h, c))
    gates = x @ wx + h @ wh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    si, sf, tg, so = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = sf * c + si * tg
    h_new = so * torch.tanh(c_new)
    return (h_new.to(out_dtype), c_new.to(out_dtype),
            torch.cat([si, sf, tg, so], dim=-1).to(out_dtype))


def lstm_cell_bwd_ref(wx, wh, x, h, c, c_new, act, dh, dc):
    """The plain K5: ``(dh, dc)`` through one cell step.

    The algebra of ``_lstm_bwd_kernel`` (``src/repro/kernels/lstm_cell.py``):
    pre-activation gate cotangents from the saved activations, then the
    products that contract 4H (``dx``, ``dh_prev``) and the batch (``dwx``,
    ``dwh``, ``db``). Returns ``dx (B,I), dh_prev (B,H), dc_prev (B,H),
    dwx (I,4H), dwh (H,4H), db (4H,)``.

    In bf16 (every input, as K5 takes them) the inputs are widened, the gate
    cotangents and every product run in float32, and ``dx``, ``dh_prev`` and
    ``dc_prev`` are rounded to bf16 once. The weight gradients stay the
    float32 sums over the whole batch, as the reference kernel emits them
    (``:213-219``); :class:`~repro_torch.kernels.lstm_cell.LSTMCell` rounds
    them to the weight dtype once, after that sum (``:246-249``).
    """
    out_dtype = x.dtype
    wx, wh, x, h = (widen(t) for t in (wx, wh, x, h))
    dgates, dc_prev = lstm_cell_bwd_cotangents(c, c_new, act, dh, dc)
    return ((dgates @ wx.t()).to(out_dtype), (dgates @ wh.t()).to(out_dtype),
            dc_prev.to(out_dtype), x.t() @ dgates, h.t() @ dgates, dgates.sum(dim=0))


def lstm_cell_bwd_dx_ref(wx, wh, c, c_new, act, dh, dc):
    """The plain dx-only K5: :func:`lstm_cell_bwd_ref`'s ``dx (B,I), dh_prev
    (B,H), dc_prev (B,H)`` alone, for a step whose weights need no gradient
    (the esn head's frozen reservoir); the same arithmetic, rounded to the
    stream dtype once in bf16."""
    out_dtype = c.dtype
    wx, wh = widen(wx), widen(wh)
    dgates, dc_prev = lstm_cell_bwd_cotangents(c, c_new, act, dh, dc)
    return ((dgates @ wx.t()).to(out_dtype), (dgates @ wh.t()).to(out_dtype),
            dc_prev.to(out_dtype))


def lstm_cell_bwd_cotangents(c, c_new, act, dh, dc):
    """The first half of :func:`lstm_cell_bwd_ref`: the pre-activation gate
    cotangents ``dgates = [di | df | dg | do]`` (B, 4H) and ``dc_prev``
    (B, H), both float32 (the inputs widened)."""
    c, c_new, act, dh, dc = (widen(t) for t in (c, c_new, act, dh, dc))
    si, sf, tg, so = act.chunk(4, dim=-1)
    tc = torch.tanh(c_new)
    # h = so * tanh(c_new); c_new = sf * c + si * tg
    do_pre = dh * tc * so * (1.0 - so)
    dct = dc + dh * so * (1.0 - tc * tc)
    df_pre = dct * c * sf * (1.0 - sf)
    di_pre = dct * tg * si * (1.0 - si)
    dg_pre = dct * si * (1.0 - tg * tg)
    return torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1), dct * sf


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """The plain K6: multi-head attention with GQA head grouping.

    q: (B, Hq, Tq, D); k: (B, Hkv, Tk, D); v: (B, Hkv, Tk, DV), its head dim
    its own (MLA: D = 192, DV = 128) -> (B, Hq, Tq, DV); Hq % Hkv == 0. The
    causal offset aligns the *ends* of q and k (decode-append: key j is
    visible to query i iff ``j <= i + Tk - Tq``). ``scale`` defaults to
    1/sqrt(D).

    The port of ``src/repro/kernels/ref.py:attention_ref`` with the kernel's
    arithmetic: K/V heads repeated, logits in fp32 from the inputs' values,
    softmax in fp32, probabilities cast to ``v.dtype`` before the product
    with V. Masked logits are -inf (a row always sees key 0 when Tq <= Tk).
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def attention_decode_ref(q, k, v, *, causal: bool = True, scale=None, n_split: int = 1):
    """K6's decode route in plain torch: the keys cut into ``n_split``
    ranges of ``ceil(Tk / n_split)`` (the last shorter; with more splits
    than that covers, the rest hold no key), each range's partial
    softmax, then the combine. Arguments and result as :func:`attention_ref`.

    Per range s, in fp32: m_s = the row's largest visible logit, p = exp(s -
    m_s), l_s = sum(p), acc_s = (p cast to v's dtype) . v; a range in
    which a row sees no key has m_s = -inf, l_s = 0 and acc_s = 0 (its
    reference point taken as 0, so nothing is NaN). The combine: m =
    max_s m_s, l = sum_s exp(m_s - m) l_s, acc likewise, o = acc / max(l,
    1e-30) in v's dtype. The kernel does the same in log2 units.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, float("-inf"))
    keys = -(-tk // n_split)
    m_parts, l_parts, acc_parts = [], [], []
    for s in range(n_split):
        lo, hi = min(s * keys, tk), min((s + 1) * keys, tk)
        part = logits[..., lo:hi]
        if hi > lo:
            m = part.amax(dim=-1, keepdim=True)
        else:
            m = logits.new_full((b, hq, tq, 1), float("-inf"))
        p = torch.exp(part - torch.where(torch.isinf(m), torch.zeros_like(m), m))
        m_parts.append(m)
        l_parts.append(p.sum(dim=-1, keepdim=True))
        acc_parts.append(torch.matmul(p.to(v.dtype).float(), v[..., lo:hi, :].float()))
    m_all = torch.stack(m_parts)
    m_top = m_all.amax(dim=0)
    weight = torch.exp(m_all - torch.where(torch.isinf(m_top), torch.zeros_like(m_top), m_top))
    l_sum = (weight * torch.stack(l_parts)).sum(dim=0)
    acc = (weight * torch.stack(acc_parts)).sum(dim=0)
    return (acc / l_sum.clamp_min(1e-30)).to(v.dtype)
