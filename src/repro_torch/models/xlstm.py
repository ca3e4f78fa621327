"""xLSTM blocks (ported from ``repro.models.xlstm``): mLSTM (matrix memory)
and sLSTM (scalar memory with recurrent gate connections), both with
exponential gating and a max-stabilizer.

Training runs the chunkwise-parallel mLSTM and the sLSTM token loop under a
``torch.autograd.Function`` (``SLSTMScan``) whose backward is the
reference's ``custom_vjp``: a reverse loop that emits each step's
pre-activation gradients, then one product over (L, B) for the recurrent
weights.  Decode is the same recurrence at length 1, so the state is O(1)
in the context.  Gate math is float32, as in the reference; the
projections run in the parameter dtype where the reference's do.

Layouts.  The states keep the reference's (B, H, ·) layout.  Inside the
sLSTM loops the four gates' recurrent matrices are one (H, Dh, 4·Dh) stack
(z, i, f, o) and the state is (H, B, Dh), so that a step's recurrence is one
batched product over the heads; the f-gate bias is folded into the inputs
before the loop (the reference adds it after the recurrence, so the float32
sums differ in order only).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from repro_torch._util import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PARAM_DTYPE, dense_init
from repro_torch.sharding import from_local, is_dtensor

_M0 = -1e30   # the stabilizer's initial value


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #

class MLSTMState(NamedTuple):
    """Recurrent state of one mLSTM layer, float32."""
    C: torch.Tensor   # (B, H, Dv, Dk) matrix memory
    n: torch.Tensor   # (B, H, Dk)
    m: torch.Tensor   # (B, H) stabilizer


def init_mlstm(generator: torch.Generator, cfg: ModelConfig, dtype=PARAM_DTYPE) -> dict:
    """Projections drawn from ``generator`` (the gate projections wi, wf
    float32), f_bias 3.0 (forget gates open at init), norm zeros."""
    D, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    g = generator
    return {
        "wq": dense_init(g, (D, H * Dh), dtype=dtype),
        "wk": dense_init(g, (D, H * Dh), dtype=dtype),
        "wv": dense_init(g, (D, H * Dh), dtype=dtype),
        "wi": dense_init(g, (D, H), dtype=f32),
        "wf": dense_init(g, (D, H), dtype=f32),
        "wog": dense_init(g, (D, H * Dh), dtype=dtype),
        "wo": dense_init(g, (H * Dh, D), dtype=dtype),
        "f_bias": torch.full((H,), 3.0, dtype=f32, device=g.device),
        "norm": torch.zeros((D,), dtype=f32, device=g.device),
    }


def _mlstm_gates(p: dict, h: torch.Tensor):
    """(q, k, v) in h's dtype (k scaled by 1/√Dh in that dtype), log_i and
    log_f (B, L, H) float32, og (B, L, H, Dh) float32."""
    B, L, D = h.shape
    H = p["wi"].shape[1]
    Dh = p["wq"].shape[1] // H
    q = (h @ p["wq"]).reshape(B, L, H, Dh)
    k = (h @ p["wk"]).reshape(B, L, H, Dh) / torch.sqrt(
        torch.full((), Dh, dtype=h.dtype, device=h.device))
    v = (h @ p["wv"]).reshape(B, L, H, Dh)
    hf = h.float()
    # float32 products, as the reference's promotion makes them once an
    # optimizer step has cast every leaf to the parameter dtype
    log_i = hf @ p["wi"].float()                                      # (B,L,H)
    log_f = Fn.logsigmoid(hf @ p["wf"].float() + p["f_bias"])
    og = torch.sigmoid((h @ p["wog"]).float()).reshape(B, L, H, Dh)
    return q, k, v, log_i, log_f, og


def _mlstm_step(state: MLSTMState, q, k, v, log_i, log_f, og
                ) -> tuple[MLSTMState, torch.Tensor]:
    """One recurrence step; every input (B, H, ...) float32.  Returns (the
    new state, y (B, H, Dh))."""
    B, H, Dh = k.shape
    lfm = log_f + state.m
    m_new = torch.maximum(lfm, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(lfm - m_new)
    # C·f + i·v kᵀ, as one batched rank-1 update over the B·H heads
    C = torch.baddbmm((state.C * f_p[..., None, None]).view(B * H, Dh, Dh),
                      (i_p[..., None] * v).view(B * H, Dh, 1), k.reshape(B * H, 1, Dh)
                      ).view(B, H, Dh, Dh)
    n = torch.addcmul(state.n * f_p[..., None], i_p[..., None], k)
    num = torch.matmul(C, q[..., None])[..., 0]
    den = torch.maximum(torch.abs((n * q).sum(-1)), torch.exp(-m_new))
    return MLSTMState(C, n, m_new), og * num / den[..., None]


def mlstm_forward(p: dict, h: torch.Tensor, cfg: ModelConfig, *, chunk: int = 64
                  ) -> torch.Tensor:
    """Chunkwise-parallel mLSTM (exact, stabilized): (B, L, D) → (B, L, D).

    A Python loop over the L/Q chunks carries (C, n, m); the Q positions of
    a chunk are handled with masked products.  With b_τ = Σ_{s≤τ} lf_s,
    a_s = li_s − b_s and w_τ = max(m_prev, cummax_τ(a)), the intra-chunk
    weight is exp(a_s − w_τ)·(q_τ·k_s) and the inter-chunk one
    exp(m_prev − w_τ)·(q_τ·C_prev); the per-position stabilizer b_τ + w_τ is
    the sequential rule's running max.  A length the chunk does not divide
    takes the sequential recurrence (``_mlstm_forward_seq``), as in the
    reference."""
    B, L, D = h.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    Q = min(chunk, L)
    if L % Q != 0:
        return _mlstm_forward_seq(p, h, cfg)
    G = L // Q
    q, k, v, log_i, log_f, og = _mlstm_gates(p, h)

    def to_chunks(x):   # (B, L, H[, Dh]) → G × (B, Q, H[, Dh]) float32
        return x.float().reshape(B, G, Q, *x.shape[2:]).unbind(1)

    qc, kc, vc, lic, lfc = (to_chunks(x) for x in (q, k, v, log_i, log_f))
    st = init_mlstm_state(cfg, B, device=h.device)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=h.device))
    ys = []
    for g in range(G):
        qt, kt, vt, li, lf = qc[g], kc[g], vc[g], lic[g], lfc[g]
        b = torch.cumsum(lf, dim=1)                                   # (B,Q,H) inclusive
        a = li - b
        w = torch.maximum(st.m[:, None, :], torch.cummax(a, dim=1).values)
        inter = torch.exp(st.m[:, None, :] - w)                       # (B,Q,H)
        src = torch.exp(a[:, None, :, :] - w[:, :, None, :])          # (B,τ,s,H)
        src = torch.where(mask[None, :, :, None], src, 0.0)
        scores = torch.einsum("bqhd,bshd->bqsh", qt, kt) * src
        num = (torch.einsum("bqsh,bshd->bqhd", scores, vt)
               + inter[..., None] * torch.einsum("bqhd,bhvd->bqhv", qt, st.C))
        den = scores.sum(2) + inter * torch.einsum("bqhd,bhd->bqh", qt, st.n)
        guard = torch.exp(-(b + w))                                   # exp(−M_τ)
        ys.append(num / torch.maximum(torch.abs(den), guard)[..., None])
        # chunk-end state (τ = Q)
        wQ = w[:, -1]                                                 # (B,H)
        dec = torch.exp(st.m - wQ)
        upd = torch.exp(a - wQ[:, None, :])                           # (B,Q,H)
        C = st.C * dec[..., None, None] + torch.einsum("bqhv,bqhd->bhvd",
                                                       vt * upd[..., None], kt)
        n = st.n * dec[..., None] + torch.einsum("bqhd,bqh->bhd", kt, upd)
        st = MLSTMState(C, n, b[:, -1] + wQ)
    y = torch.stack(ys, dim=1).reshape(B, L, H, Dh)
    y = (og * y).reshape(B, L, H * Dh)
    return y.to(h.dtype) @ p["wo"]


def _mlstm_forward_seq(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential recurrence from the zero state (the chunkwise form's
    oracle)."""
    return mlstm_prefill(p, h, init_mlstm_state(cfg, h.shape[0], device=h.device), cfg)[0]


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device="cuda") -> MLSTMState:
    """Zero memory, stabilizer −1e30, float32."""
    device = resolve_device(device)
    B, H, Dh, f32 = batch, cfg.n_heads, cfg.head_dim, torch.float32
    return MLSTMState(torch.zeros((B, H, Dh, Dh), dtype=f32, device=device),
                      torch.zeros((B, H, Dh), dtype=f32, device=device),
                      torch.full((B, H), _M0, dtype=f32, device=device))


def mlstm_prefill(p: dict, h: torch.Tensor, state: MLSTMState, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, MLSTMState]:
    """The L tokens of h (B, L, D) through ``_mlstm_step`` one after another
    from ``state``: (out (B, L, D), the state the sequential decode
    reaches).  The gates, which do not depend on the state, are computed
    for all L tokens at once."""
    B, L, _ = h.shape
    q, k, v, log_i, log_f, og = _mlstm_gates(p, h)
    per_tok = [x.float().unbind(1) for x in (q, k, v, log_i, log_f, og)]
    ys = []
    for t in range(L):
        state, y = _mlstm_step(state, *(x[t] for x in per_tok))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, L, cfg.n_heads * cfg.head_dim)
    return y.to(h.dtype) @ p["wo"], state


def mlstm_decode(p: dict, h_t: torch.Tensor, state: MLSTMState, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, MLSTMState]:
    """One-token step.  h_t: (B, 1, D).  Returns (out (B, 1, D), the new
    state); the input state is not modified."""
    return mlstm_prefill(p, h_t, state, cfg)


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #

class SLSTMState(NamedTuple):
    """Recurrent state of one sLSTM layer, float32, each (B, H, Dh)."""
    c: torch.Tensor
    n: torch.Tensor
    hst: torch.Tensor
    m: torch.Tensor


def init_slstm(generator: torch.Generator, cfg: ModelConfig, dtype=PARAM_DTYPE) -> dict:
    """Input projections (wi, wf float32), the four per-head recurrent
    matrices (H, Dh, Dh) float32 with fan-in Dh, f_bias 3.0, norm zeros."""
    D, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    g = generator
    return {
        "wz": dense_init(g, (D, H * Dh), dtype=dtype),
        "wi": dense_init(g, (D, H * Dh), dtype=f32),
        "wf": dense_init(g, (D, H * Dh), dtype=f32),
        "wog": dense_init(g, (D, H * Dh), dtype=dtype),
        "rz": dense_init(g, (H, Dh, Dh), in_axis=1, dtype=f32),
        "ri": dense_init(g, (H, Dh, Dh), in_axis=1, dtype=f32),
        "rf": dense_init(g, (H, Dh, Dh), in_axis=1, dtype=f32),
        "rog": dense_init(g, (H, Dh, Dh), in_axis=1, dtype=f32),
        "wo": dense_init(g, (H * Dh, D), dtype=dtype),
        "f_bias": torch.full((H * Dh,), 3.0, dtype=f32, device=g.device),
        "norm": torch.zeros((D,), dtype=f32, device=g.device),
    }


def _pre_stack(xz, xi, xf, xog, f_bias, H: int) -> torch.Tensor:
    """The four input pre-activations (L, B, H·Dh), the f-gate bias added,
    as one (L, H, B, 4·Dh) tensor, gates in the order z, i, f, o."""
    L, B, HD = xz.shape
    Dh = HD // H
    x = torch.stack([xz, xi, xf + f_bias, xog], dim=2).view(L, B, 4, H, Dh)
    return x.permute(0, 3, 1, 2, 4).reshape(L, H, B, 4 * Dh)


def _r_stack(rz, ri, rf, rog, dtype) -> torch.Tensor:
    """The recurrent matrices as one (H, Dh, 4·Dh) stack in the gates'
    ``dtype`` (the reference promotes them to it)."""
    return torch.cat([rz, ri, rf, rog], dim=2).to(dtype)


def _slstm_cell(pre: torch.Tensor, c, n, m):
    """One step's gate math.  pre: (H, B, 4·Dh) pre-activations with the
    recurrence; c, n, m: (H, B, Dh).  Returns (h, c, n, m); m is the
    running max (not differentiated through, as the reference's
    stop_gradient)."""
    H, B, D4 = pre.shape
    pz, li, pf, po = pre.view(H, B, 4, D4 // 4).unbind(2)
    lfm = Fn.logsigmoid(pf) + m
    m_new = torch.maximum(lfm, li).detach()
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lfm - m_new)
    c = torch.addcmul(f_p * c, i_p, torch.tanh(pz))
    n = torch.maximum(torch.addcmul(i_p, f_p, n), torch.exp(-m_new))
    return torch.sigmoid(po) * c / n, c, n, m_new


def _slstm_loop(R: torch.Tensor, X: torch.Tensor, h, c, n, m):
    """The token loop: X (L, H, B, 4·Dh), R (H, Dh, 4·Dh), the state
    (H, B, Dh) each.  Returns the (L, H, B, Dh) stacks of h, c, n, m."""
    hs, cs, ns, ms = [], [], [], []
    for x_t in X.unbind(0):
        h, c, n, m = _slstm_cell(torch.baddbmm(x_t, h, R), c, n, m)
        hs.append(h)
        cs.append(c)
        ns.append(n)
        ms.append(m)
    return tuple(torch.stack(s) for s in (hs, cs, ns, ms))


def _zero_hbd(H: int, B: int, Dh: int, like: torch.Tensor):
    z = torch.zeros((H, B, Dh), dtype=like.dtype, device=like.device)
    return z, z, z, torch.full((H, B, Dh), _M0, dtype=like.dtype, device=like.device)


class SLSTMScan(torch.autograd.Function):
    """The sLSTM time loop from the zero state with the reference's
    one-product weight-gradient backward (``repro.models.xlstm``'s
    ``custom_vjp``).

    forward(R (H, Dh, 4·Dh), X (L, H, B, 4·Dh)) → hs (L, H, B, Dh).  The
    forward loop runs without autograd and keeps the h, c, n, m stacks.  The
    backward recomputes every step's gates at once from the saved stacks,
    runs the reverse loop over the three carried gradients (h, c, n) alone
    — each step's pre-activation gradients are a fixed linear function of
    them, with coefficients computed before the loop — and emits those
    gradients, then forms dR as one product over (L, B) after the loop.
    The stabilizer m is held constant (the reference's stop_gradient)."""

    @staticmethod
    def forward(ctx, R, X):
        L, H, B, D4 = X.shape
        hs, cs, ns, ms = _slstm_loop(R, X, *_zero_hbd(H, B, D4 // 4, X))
        ctx.save_for_backward(R, X, hs, cs, ns, ms)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        R, X, hs, cs, ns, ms = ctx.saved_tensors
        L, H, B, D4 = X.shape
        Dh = D4 // 4
        h0, c0, n0, m0 = _zero_hbd(H, B, Dh, X)

        def shift(s, first):
            return torch.cat([first[None], s[:-1]])

        h_prev, c_prev, n_prev, m_prev = (shift(s, f) for s, f in
                                          zip((hs, cs, ns, ms), (h0, c0, n0, m0)))
        # every step's gates at once, from the saved stacks
        rec = torch.bmm(h_prev.permute(1, 0, 2, 3).reshape(H, L * B, Dh), R)
        pre = X + rec.view(H, L, B, D4).permute(1, 0, 2, 3)
        pz, li, pf, po = pre.view(L, H, B, 4, Dh).unbind(3)
        z = torch.tanh(pz)
        lf = Fn.logsigmoid(pf)
        i_p = torch.exp(li - ms)
        f_p = torch.exp(lf + m_prev - ms)
        o = torch.sigmoid(po)
        sw = (f_p * n_prev + i_p >= torch.exp(-ms)).to(X.dtype)      # n's max switch
        # the step's gradients as linear maps of the carried (gh, gc, gn):
        # gc += gh·o/n, gn += −gh·o·c/n², and the four pre-activation
        # gradients gc·Pc + gn·Pn + gh·Ph (gates z, i, f, o)
        a_c = o / ns
        a_n = -o * cs / (ns * ns)
        dsig = 1.0 - torch.exp(lf)                                    # ∂log_sigmoid
        zero = torch.zeros_like(z)
        Pc = torch.stack([i_p * (1.0 - z * z), z * i_p, c_prev * f_p * dsig, zero], dim=3)
        Pn = torch.stack([zero, sw * i_p, sw * n_prev * f_p * dsig, zero], dim=3)
        Ph = torch.stack([zero, zero, zero, cs / ns * o * (1.0 - o)], dim=3)
        sw_fp = sw * f_p
        RT = R.transpose(1, 2)
        gh_in = gc_in = gn_in = torch.zeros((H, B, Dh), dtype=X.dtype, device=X.device)
        ds = []
        for t in range(L - 1, -1, -1):
            gh = g_hs[t] + gh_in
            gc = torch.addcmul(gc_in, gh, a_c[t])
            gn = torch.addcmul(gn_in, gh, a_n[t])
            d = torch.addcmul(torch.addcmul(gh[:, :, None] * Ph[t], gc[:, :, None], Pc[t]),
                              gn[:, :, None], Pn[t]).view(H, B, D4)
            ds.append(d)
            if t == 0:
                break                       # the zero initial state takes no gradient
            gh_in = torch.bmm(d, RT)
            gc_in = gc * f_p[t]
            gn_in = gn * sw_fp[t]
        dX = torch.stack(ds[::-1])                                     # (L, H, B, 4·Dh)
        # dR = Σ_{l,b} h_{t−1} ⊗ dpre as one product over (L, B)
        dR = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(H, Dh, L * B),
                       dX.permute(1, 0, 2, 3).reshape(H, L * B, D4))
        return dR, dX


def slstm_scan(R, f_bias, xz, xi, xf, xog) -> torch.Tensor:
    """The reference's ``_slstm_scan``: R = (rz, ri, rf, rog) each
    (H, Dh, Dh), f_bias (H·Dh,), x* (L, B, H·Dh) input pre-activations →
    hs (L, B, H, Dh), differentiated by ``SLSTMScan``."""
    H = R[0].shape[0]
    X = _pre_stack(xz, xi, xf, xog, f_bias, H)
    Rs = _r_stack(*R, X.dtype)
    if is_dtensor(X):
        hs = _scan_on_shards(Rs, X)
    else:
        hs = SLSTMScan.apply(Rs, X)
    return hs.permute(0, 2, 1, 3)


def _scan_on_shards(R, X):
    """``SLSTMScan`` on a mesh: each rank's own batch rows (every row's
    recurrence is its own) through the scan on local tensors, R gathered
    whole; the hidden states placed as X, and R's gradient a partial sum
    over the ranks that split the batch (DTensor's reshapes refuse the
    backward's merge of a split batch with the time axis)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = X.device_mesh
    rep = [Replicate()] * dm.ndim
    batch = [pl if pl == Shard(2) else Replicate() for pl in X.placements]
    if list(X.placements) != batch:
        X = X.redistribute(dm, batch)       # (L, H, B, 4·Dh): the batch split alone
    grad = [Replicate() if pl == Replicate() else Partial() for pl in X.placements]
    if is_dtensor(R):
        R = R.redistribute(dm, rep).to_local(grad_placements=grad)
    L, H, B, D4 = X.shape
    hs = SLSTMScan.apply(R, X.to_local())
    return from_local(hs, dm, X.placements, (L, H, B, D4 // 4))


def slstm_scan_plain(R, f_bias, xz, xi, xf, xog) -> torch.Tensor:
    """``slstm_scan`` with autograd through the token loop (the plain form
    ``SLSTMScan``'s backward is held against)."""
    H = R[0].shape[0]
    X = _pre_stack(xz, xi, xf, xog, f_bias, H)
    L, H, B, D4 = X.shape
    hs = _slstm_loop(_r_stack(*R, X.dtype), X, *_zero_hbd(H, B, D4 // 4, X))[0]
    return hs.permute(0, 2, 1, 3)


def _slstm_x(p: dict, h: torch.Tensor):
    """The input pre-activations (L, B, H·Dh) float32: z and o through the
    parameter-dtype projections, i and f through the float32 ones."""
    hf = h.float()
    xz = (h @ p["wz"]).float()
    xi = hf @ p["wi"].float()
    xf = hf @ p["wf"].float()
    xog = (h @ p["wog"]).float()
    return tuple(x.transpose(0, 1) for x in (xz, xi, xf, xog))


def _r_of(p: dict):
    return (p["rz"], p["ri"], p["rf"], p["rog"])


def slstm_forward(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, L, D) → (B, L, D) from the zero state, through ``SLSTMScan``."""
    B, L, D = h.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    ys = slstm_scan(_r_of(p), p["f_bias"], *_slstm_x(p, h))        # (L, B, H, Dh)
    y = ys.transpose(0, 1).reshape(B, L, H * Dh)
    return y.to(h.dtype) @ p["wo"]


def init_slstm_state(cfg: ModelConfig, batch: int, *, device="cuda") -> SLSTMState:
    """c, n and h zero, the stabilizer −1e30, float32."""
    device = resolve_device(device)
    shape = (batch, cfg.n_heads, cfg.head_dim)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full(shape, _M0, dtype=torch.float32, device=device))


def slstm_prefill(p: dict, h: torch.Tensor, state: SLSTMState, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, SLSTMState]:
    """The L tokens of h (B, L, D) through the recurrence one token after
    another from ``state``: (out (B, L, D), the state the sequential decode
    reaches).  The input projections of all L tokens are computed first."""
    B, L, D = h.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    X = _pre_stack(*_slstm_x(p, h), p["f_bias"], H)
    hbd = [s.transpose(0, 1) for s in (state.hst, state.c, state.n, state.m)]
    hs, cs, ns, ms = _slstm_loop(_r_stack(*_r_of(p), X.dtype), X, *hbd)
    y = hs.permute(2, 0, 1, 3).reshape(B, L, H * Dh)
    last = [s[-1].transpose(0, 1) for s in (cs, ns, hs, ms)]
    return y.to(h.dtype) @ p["wo"], SLSTMState(*last)


def slstm_decode(p: dict, h_t: torch.Tensor, state: SLSTMState, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, SLSTMState]:
    """One-token step.  h_t: (B, 1, D).  Returns (out (B, 1, D), the new
    state); the input state is not modified."""
    return slstm_prefill(p, h_t, state, cfg)

