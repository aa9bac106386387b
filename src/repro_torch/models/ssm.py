"""The SSD chunked scan of Mamba2 (state-space duality, Dao & Gu 2024,
arXiv:2405.21060), as the ``ssm`` forecasting head uses it.

PyTorch port of ``_segsum`` and ``ssd_chunked`` of ``repro.models.ssm``
(``src/repro/models/ssm.py:74-149``); the rest of that module (the Mamba2
block, its caches and decode step) belongs to the LM stack and is not here.

Within a chunk of Q positions the mixing is a masked quadratic (an
attention-like einsum); across chunks a first-order recurrence carries the
(H, P, N) state. That recurrence runs as a loop over the chunks (at most
ceil(T / Q) of them), carried in float32. The decay and segment sums stay
float32; the large einsum operands and outputs take the input dtype, as in
the reference (``:104-108``), so under the bf16 policy they are bf16.
"""

from __future__ import annotations

import torch

__all__ = ["segsum", "ssd_chunked"]


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: ``out[..., i, j] = sum_{j < l <= i} a[..., l]``.

    a: (..., Q). Returns (..., Q, Q) with -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=a.device)
    return diff.masked_fill(i[:, None] < i[None, :], float("-inf"))


def ssd_chunked(x, dt, a, bb, cc, *, chunk: int):
    """SSD forward. x: (B, T, H, P); dt: (B, T, H) float32; a: (H,) negative
    float32; bb, cc: (B, T, G, N) with G dividing H. T must be a multiple of
    ``min(chunk, T)``. Returns y (B, T, H, P) in x's dtype and the final
    state (B, H, P, N) in float32."""
    b, t, h, p = x.shape
    g, n = bb.shape[2], bb.shape[3]
    q = min(chunk, t)
    nc = t // q
    if nc * q != t:
        raise ValueError(f"T = {t} is not a multiple of the SSD chunk {q}")
    rep = h // g

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc = bb.reshape(b, nc, q, g, n)
    ccc = cc.reshape(b, nc, q, g, n)
    cdt = x.dtype
    da = dtc * a                                        # (B, NC, Q, H), negative
    cum = torch.cumsum(da, dim=2)

    # intra-chunk (diagonal) term: the decay in float32, the (Q, Q) product
    # chain in the input dtype
    l_mat = torch.exp(segsum(da.movedim(3, 2))).to(cdt)  # (B, NC, H, Q, Q)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", ccc, bc).repeat_interleave(rep, dim=2)
    scores = cb * l_mat * dtc.movedim(3, 2).to(cdt)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # chunk-final states: sum_k exp(cum_end - cum_k) dt_k B_k x_k
    decay = torch.exp(cum[:, :, -1:, :] - cum)          # (B, NC, Q, H)
    xw = xc * (dtc * decay).to(cdt)[..., None]          # (B, NC, Q, H, P)
    bh = bc.repeat_interleave(rep, dim=3)               # (B, NC, Q, H, N)
    states = torch.einsum("bcqhn,bcqhp->bchpn", bh, xw).float()

    # inter-chunk recurrence S_c = exp(sum da_c) S_{c-1} + states_c, in
    # float32; each chunk reads the state entering it
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B, NC, H)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)                     # (B, NC, H, P, N)

    # inter-chunk contribution: C_t . (decay-to-t * S_in)
    ch = ccc.repeat_interleave(rep, dim=3)              # (B, NC, Q, H, N)
    y_off = (torch.einsum("bcqhn,bchpn->bcqhp", ch, s_in.to(cdt))
             * torch.exp(cum).to(cdt)[..., None])
    return (y_diag + y_off).reshape(b, t, h, p), s
