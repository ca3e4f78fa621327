"""AccumAttention — the paper's accumulation-of-sub-sampling sketch transported
to transformer attention (ported from ``repro.core.sketched_attention``).

The attention matrix A = softmax(QKᵀ/√h) is an empirical (asymmetric) kernel
matrix; with landmarks built by the accumulation sketch in the key/query
feature domain,

    K̃ = Sᵀ K,  Q̃ = Sᵀ Q                                  (d landmarks, m accumulations)
    F = softmax(Q K̃ᵀ/√h)  (n×d),  W = softmax(Q̃ K̃ᵀ/√h)  (d×d),
    Bm = softmax(Q̃ Kᵀ/√h) (d×n)
    out = F · W⁺ · (Bm V)                                  — O(n·d) not O(n²)

m = 1 recovers Nyströmformer-style sub-sampled landmarks.  W⁺ by
Newton–Schulz iteration.

Streaming decode (long-context serving): every arriving token scatter-adds
into ``m_r`` of the d landmark slots, unsigned, and the slot mass is tracked
for an exact log-mass correction — exact when slots are singletons, so the
decode degrades gracefully to full attention when d ≥ seen tokens.

The scatter-adds are folds in a fixed order: every update of a slot is added
in (token, pick) order and rounded to the cache dtype after each add, with
out-of-range slots (the Poisson padding marker ``d_slots``) dropped.  The
prefill and the token-by-token decode share that one fold, so the prefill
cache is bitwise the sequential loop's on any device.  Slot tables are host
data (they are drawn on the host): a table on the card is read back first.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._util import SLOT_STREAM, position_generator, resolve_device
from repro_torch.core.apply import default_use_kernel
from repro_torch.core.sketch import AccumSketch, make_accum_sketch

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# Landmark construction
# --------------------------------------------------------------------------- #

def landmark_pool(x: torch.Tensor, sk: AccumSketch, *,
                  normalize: bool = False) -> torch.Tensor:
    """Sᵀ x over the sequence axis. x: (..., S, D) → (..., d, D).

    Shared sketch across batch/head axes.  ``normalize=True`` rescales each
    landmark by its total coefficient mass, so a landmark is the weighted
    mean of its m pooled rows (signs do not commute with the softmax)."""
    rows = x.index_select(-2, sk.indices.reshape(-1).to(x.device, torch.long))
    rows = rows.reshape(rows.shape[:-2] + (sk.m, sk.d, rows.shape[-1]))
    coef = sk.coef.to(x.device, x.dtype)
    pooled = torch.einsum("...mdk,md->...dk", rows, coef)
    if normalize:
        mass = torch.sum(torch.abs(coef), dim=0)                     # (d,)
        pooled = pooled / torch.clamp_min(mass, 1e-30)[:, None]
    return pooled


def _newton_schulz_pinv(W: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Iterative pseudo-inverse of a (…, d, d) matrix (Nyströmformer's trick)."""
    d = W.shape[-1]
    eye = torch.eye(d, dtype=W.dtype, device=W.device)
    norm = (torch.amax(torch.sum(torch.abs(W), dim=-2), dim=-1)
            * torch.amax(torch.sum(torch.abs(W), dim=-1), dim=-1))
    Z = W.transpose(-1, -2) / norm[..., None, None]
    for _ in range(iters):
        WZ = W @ Z
        Z = 0.25 * Z @ (13.0 * eye - WZ @ (15.0 * eye - WZ @ (7.0 * eye - WZ)))
    return Z


def softmax_scale(Dh: int) -> float:
    """1/√Dh in float32, as a host number: every logit it scales is float32,
    so the product is the one with a float32 tensor, and no tensor is made
    or copied to the device.  numpy's square root is correctly rounded; it
    equals PyTorch's CPU float32 value at every head dim to 1024 but 267,
    and at every configured one."""
    return float(np.float32(1.0) / np.sqrt(np.float32(Dh)))


def accum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sk: AccumSketch, *, pinv_iters: int = 6,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Sketched (landmark) attention, O(S·d), bidirectional.

    q: (B, H, Sq, Dh); k, v: (B, H, Sk, Dh); ``sk`` over the key sequence
    axis.  Returns (B, H, Sq, Dh) in q's dtype; float32 softmaxes.
    ``use_kernel`` (default: True on a CUDA device) routes the two O(S·d)
    stages through the landmark kernels; the fused sweep never builds the
    (d, S) Bm softmax.  A failing kernel raises — there is no fallback."""
    if use_kernel is None:
        use_kernel = default_use_kernel(q.device)
    if use_kernel:
        from repro_torch.kernels.landmark_attention.ops import accum_attention_kernel

        return accum_attention_kernel(q, k, v, sk, pinv_iters=pinv_iters)
    scale = softmax_scale(q.shape[-1])
    kt = landmark_pool(k, sk, normalize=True).float()               # (B,H,d,Dh)
    qt = landmark_pool(q, sk, normalize=True).float()
    F = torch.softmax((q.float() @ kt.transpose(-1, -2)) * scale, dim=-1)
    W = torch.softmax((qt @ kt.transpose(-1, -2)) * scale, dim=-1)
    Bm = torch.softmax((qt @ k.float().transpose(-1, -2)) * scale, dim=-1)
    Winv = _newton_schulz_pinv(W, pinv_iters)
    out = F @ (Winv @ (Bm @ v.float()))
    return out.to(q.dtype)


def exact_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """O(S²) reference attention (oracle for tests / small configs)."""
    scale = softmax_scale(q.shape[-1])
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk_ = q.shape[-2], k.shape[-2]
        mask = torch.ones((sq, sk_), dtype=torch.bool, device=q.device).tril(sk_ - sq)
        logits = torch.where(mask, logits, NEG_INF)
    return (torch.softmax(logits, dim=-1) @ v.float()).to(q.dtype)


# --------------------------------------------------------------------------- #
# Streaming sketched KV cache (long-context decode)
# --------------------------------------------------------------------------- #

class SketchCache(NamedTuple):
    """Compressed KV cache: d_slots landmark slots per layer/head."""
    k_sum: torch.Tensor    # (B, Hkv, d_slots, Dh) — Σ c_i k_i per slot
    v_sum: torch.Tensor    # (B, Hkv, d_slots, Dh)
    mass: torch.Tensor     # (B, Hkv, d_slots)     — Σ c_i per slot, float32


def init_sketch_cache(batch, kv_heads, d_slots, head_dim, dtype=torch.float32, *,
                      device="cuda") -> SketchCache:
    """Zero-initialized decode-time landmark cache.  ``dtype`` applies to the
    k/v slot sums; ``mass`` stays float32 always (a bfloat16 count stops
    resolving +c increments after a few hundred tokens)."""
    device = resolve_device(device)
    shape = (batch, kv_heads, d_slots, head_dim)
    return SketchCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape[:3], dtype=torch.float32, device=device))


def _contrib_scale(m_r: int) -> float:
    """c = 1/√m_r in float32 (so E[SSᵀ] = I), as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(m_r)))


def _slot_contrib(x: torch.Tensor, m_r: int, dtype) -> torch.Tensor:
    """Per-slot contribution c·x, computed in float32 and rounded ONCE to the
    cache dtype — shared by the sequential and the batched paths."""
    return (x.float() * _contrib_scale(m_r)).to(dtype)


def _host_table(slots) -> np.ndarray:
    if isinstance(slots, torch.Tensor):
        slots = slots.cpu()
    return np.ascontiguousarray(np.asarray(slots, dtype=np.int64))


@functools.lru_cache(maxsize=512)
def _fold_rounds(table_bytes: bytes, shape: tuple, d_slots: int, device: str, fake_mode=None):
    """The fold's schedule for a (T, m_r) slot table: rounds of (token,
    slot) index pairs in which no slot repeats, round r holding each slot's
    r-th update in (token, pick) order.  Out-of-range slots are dropped.
    ``fake_mode`` keys the schedules made for the fake tensors of one
    ``FakeTensorMode`` (the dry run's) apart from the device's own."""
    flat = np.frombuffer(table_bytes, dtype=np.int64)
    m_r = shape[-1]
    upd = np.nonzero((flat >= 0) & (flat < d_slots))[0]           # (token, pick) order
    slots = flat[upd]
    order = np.argsort(slots, kind="stable")
    ss = slots[order]
    starts = np.r_[0, np.nonzero(np.diff(ss))[0] + 1]
    run = np.repeat(starts, np.diff(np.r_[starts, len(ss)]))
    rank = np.empty_like(order)
    rank[order] = np.arange(len(ss)) - run
    rounds = []
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = upd[rank == r]
        # asynchronous copies: the decode loop waits on no host transfer
        rounds.append((torch.from_numpy(sel // m_r).to(device, non_blocking=True),
                       torch.from_numpy(flat[sel]).to(device, non_blocking=True)))
    return tuple(rounds)


def _fold(cache: SketchCache, k_add: torch.Tensor, v_add: torch.Tensor,
          table: np.ndarray) -> SketchCache:
    """Fold the (B, Hkv, T, Dh) contributions into a copy of ``cache`` at
    the slots of the (T, m_r) host table, one rounded add per update in
    (token, pick) order.  The schedule is cached per table and device; its
    index tensors are only read.  On fake tensors (the dry run's
    ``FakeTensorMode``) the schedule is cached per fake mode: its index
    tensors are fakes of that mode."""
    rounds = _fold_rounds(table.tobytes(), table.shape, cache.k_sum.shape[2],
                          str(cache.k_sum.device), getattr(cache.k_sum, "fake_mode", None))
    k_sum, v_sum, mass = cache.k_sum.clone(), cache.v_sum.clone(), cache.mass.clone()
    c_mass = _contrib_scale(table.shape[-1])
    for tok, slot in rounds:
        k_sum.index_copy_(2, slot, k_sum.index_select(2, slot) + k_add.index_select(2, tok))
        v_sum.index_copy_(2, slot, v_sum.index_select(2, slot) + v_add.index_select(2, tok))
        mass.index_copy_(2, slot, mass.index_select(2, slot) + c_mass)
    return SketchCache(k_sum, v_sum, mass)


def update_sketch_cache(cache: SketchCache, k_t: torch.Tensor, v_t: torch.Tensor,
                        slots) -> SketchCache:
    """Scatter-add one new token into its m_r slots.

    k_t, v_t: (B, Hkv, Dh); slots: (m_r,) ints, shared across batch/heads.
    Duplicate slots add twice; out-of-range slots (Poisson padding) are
    dropped.  Returns a new cache."""
    return prefill_sketch_cache(cache, k_t[:, :, None], v_t[:, :, None],
                                _host_table(slots).reshape(1, -1))


def prefill_sketch_cache(cache: SketchCache, k_seq: torch.Tensor,
                         v_seq: torch.Tensor, slot_table) -> SketchCache:
    """Scatter-add ALL L tokens into their slots: k_seq, v_seq (B, Hkv, L, Dh);
    slot_table (L, m_r) (row t = the draw ``decode_slots`` makes at t).  The
    same fold as ``update_sketch_cache`` over the tokens in order, so the
    result is bitwise the sequential loop's.  Returns a new cache."""
    table = _host_table(slot_table)
    m_r = table.shape[-1]
    return _fold(cache, _slot_contrib(k_seq, m_r, cache.k_sum.dtype),
                 _slot_contrib(v_seq, m_r, cache.v_sum.dtype), table)


def sketch_prefill_attend(q_seq: torch.Tensor, k_seq: torch.Tensor,
                          v_seq: torch.Tensor, cache: SketchCache, slot_table, *,
                          chunk: int = 128, shard=None) -> tuple[torch.Tensor, SketchCache]:
    """Decode-semantics attention for all L prefill positions, chunked.

    q_seq: (B, H, L, Dh); k_seq, v_seq: (B, Hkv, L, Dh); slot_table (L, m_r).
    Position t attends over the evolving cache state after its own token's
    scatter (what the sequential update → decode loop sees).  Within a chunk
    of c tokens the cumulative cache is never built: the logit/value terms
    split into a past-carry term plus an intra-chunk term through the (c, c)
    token-score matrix and the (c, d_slots) slot-weight matrix w,

        q_t·k_sum_t[j] = q_t·carry_k[j] + Σ_{s≤t} (q_t·k_s)·w[s, j]
        out_t          = p̃_t·carry_v    + Σ_{s≤t} (p̃_t·wᵀ)[s]·v_s

    with p̃ = softmax / mass.  The carry advances through the same fold as
    ``prefill_sketch_cache``, so the returned cache is bitwise the
    sequential loop's.  Returns (out (B, H, L, Dh) in q's dtype, cache).

    ``shard`` (a mesh's slot shard, as the decode's): ``cache`` holds this
    rank's slots, ``shard.local_slots`` renumbers the table to them (another
    rank's slots become the padding marker, which the fold drops), every
    slot-wide product runs on them alone, and ``shard.combine`` joins the
    ranks' softmax partials (both terms of out are sums over slots) by
    their rows' log-sum-exps, in float32."""
    B, H, L, Dh = q_seq.shape
    Hkv = k_seq.shape[1]
    G = H // Hkv
    d_slots = cache.k_sum.shape[2]
    table = _host_table(slot_table)
    if shard is not None:
        table = shard.local_slots(table)
    m_r = table.shape[-1]
    dev = q_seq.device
    f32 = torch.float32
    scale = softmax_scale(Dh)
    c_mass = _contrib_scale(m_r)
    slot_ids = torch.arange(d_slots, device=dev)
    table_dev = torch.from_numpy(table).to(dev, non_blocking=True)
    outs = []
    for t0 in range(0, L, chunk):
        t1 = min(L, t0 + chunk)
        cm = t1 - t0
        qf = q_seq[:, :, t0:t1].reshape(B, Hkv, G, cm, Dh).float()
        kc, vc = k_seq[:, :, t0:t1], v_seq[:, :, t0:t1]
        kf, vf = kc.float(), vc.float()
        sl = table_dev[t0:t1]
        # (cm, d_slots) slot weights: Σ_r one-hot(slot)·c; out-of-range
        # padding matches nothing and stays zero
        w = (sl[:, :, None] == slot_ids).sum(dim=1).to(f32) * c_mass
        tril = torch.ones((cm, cm), dtype=torch.bool, device=dev).tril()
        mass_cum = cache.mass.float()[:, :, None, :] + torch.cumsum(w, dim=0)
        A = torch.einsum("bhgtd,bhsd->bhgts", qf, kf)
        A = torch.where(tril, A, 0.0)
        qk = (torch.einsum("bhgtd,bhjd->bhgtj", qf, cache.k_sum.float())
              + torch.einsum("bhgts,sj->bhgtj", A, w))
        mass_c = torch.clamp_min(mass_cum, 1e-30)[:, :, None]       # (B,Hkv,1,cm,d)
        logits = scale * qk / mass_c + torch.log(mass_c)
        logits = torch.where((mass_cum <= 0)[:, :, None], NEG_INF, logits)
        pn = torch.softmax(logits, dim=-1) / mass_c
        pw = torch.where(tril, torch.einsum("bhgtj,sj->bhgts", pn, w), 0.0)
        o = (torch.einsum("bhgtj,bhjd->bhgtd", pn, cache.v_sum.float())
             + torch.einsum("bhgts,bhsd->bhgtd", pw, vf))
        if shard is not None:
            o = shard.combine(o, torch.logsumexp(logits, dim=-1))
        outs.append(o.reshape(B, H, cm, Dh))
        cache = prefill_sketch_cache(cache, kc, vc, table[t0:t1])
    return torch.cat(outs, dim=2).to(q_seq.dtype), cache


def sketch_decode_attend(q_t: torch.Tensor, cache: SketchCache, *,
                         use_kernel: bool | None = None, lse: bool = False):
    """One-token attention over the compressed cache with log-mass correction.

    q_t: (B, H, Dh) with H = G·Hkv (GQA groups broadcast).  Returns
    (B, H, Dh).  logits_j = q·k̄_j/√h + log m_j, k̄_j = k_sum_j / m_j — exact
    softmax attention when every slot holds one token.  ``use_kernel``
    (default: True on a CUDA device) routes the softmax·V contraction through
    the ``landmark_attention`` kernel with the log-mass correction (and −1e30
    for empty slots) in its bias lane: one launch per call.  With ``lse``
    the pair of the output, float32, and each row's log-sum-exp of its
    logits, (B, H) float32 (the same launch writes it): a sharded decode
    combines the partials of its slot shards by them."""
    B, H, Dh = q_t.shape
    Hkv, d_slots = cache.k_sum.shape[1:3]
    G = H // Hkv
    mass = torch.clamp_min(cache.mass.float(), 1e-30)              # (B,Hkv,d)
    kbar = cache.k_sum.float() / mass[..., None]
    vbar = cache.v_sum.float() / mass[..., None]
    qg = q_t.reshape(B, Hkv, G, Dh).float()
    bias = torch.where(cache.mass <= 0, NEG_INF, torch.log(mass))
    if use_kernel is None:
        use_kernel = default_use_kernel(q_t.device)
    if use_kernel:
        from repro_torch.kernels.landmark_attention.ops import landmark_attend

        out = landmark_attend(qg.reshape(B * Hkv, G, Dh),
                              kbar.reshape(B * Hkv, d_slots, Dh),
                              vbar.reshape(B * Hkv, d_slots, Dh),
                              bias.reshape(B * Hkv, d_slots), lse=lse)
        if lse:
            return out[0].reshape(B, H, Dh), out[1].reshape(B, H)
        return out.reshape(B, H, Dh).to(q_t.dtype)
    logits = torch.einsum("bhgk,bhdk->bhgd", qg, kbar) * softmax_scale(Dh)
    logits = logits + bias[:, :, None, :]
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgd,bhdk->bhgk", p, vbar)
    if lse:
        return out.reshape(B, H, Dh), torch.logsumexp(logits, dim=-1).reshape(B, H)
    return out.reshape(B, H, Dh).to(q_t.dtype)


DECODE_SLOT_SCHEMES = ("uniform", "poisson")


def decode_slots(seed: int, step: int, d_slots: int, m_r: int, *,
                 scheme: str = "uniform", max_len: int | None = None,
                 draw: torch.Tensor | None = None) -> torch.Tensor:
    """Counter-based slot draw for position ``step``: (m_r,) int32 on the
    host; entries equal to ``d_slots`` are padding (dropped by the fold).

    The draw comes from the stream (seed, ``SLOT_STREAM``) folded with
    ``step``, so it is a pure function of (seed, step) — a resumed decode
    redraws the same slots.  ``draw`` supplies the random numbers instead:
    the (m_r,) slots for ``"uniform"``, the (d_slots,) inclusion uniforms
    for ``"poisson"`` (parity with the reference feeds its draw here).

    ``"uniform"``: m_r i.i.d. uniform slots (with replacement).
    ``"poisson"``: every slot is included with probability π = m_r/d_slots;
    at most m_r included slots are kept, ranked by their uniforms, and the
    rest of the row is padding.
    ``max_len ≤ d_slots``: the identity draw, slot ``step`` for every pick —
    every slot a singleton, so sketched decode IS exact attention."""
    if scheme not in DECODE_SLOT_SCHEMES:
        raise ValueError(
            f"unknown decode slot scheme {scheme!r}; pick from {DECODE_SLOT_SCHEMES}")
    if max_len is not None and max_len <= d_slots:
        return torch.full((m_r,), int(step) % d_slots, dtype=torch.int32)
    g = None if draw is not None else position_generator(seed, SLOT_STREAM, step)
    if scheme == "uniform":
        s = draw if draw is not None else torch.randint(0, d_slots, (m_r,), generator=g)
        return torch.as_tensor(s).to(torch.int32)
    u = draw if draw is not None else torch.rand((d_slots,), generator=g)
    u = torch.as_tensor(u, dtype=torch.float32)
    inc = u < min(1.0, m_r / d_slots)
    order = torch.argsort(torch.where(inc, u, 2.0), stable=True)[:m_r]
    valid = torch.arange(m_r) < inc.sum()
    return torch.where(valid, order, d_slots).to(torch.int32)


def decode_slot_table(seed: int, length: int, d_slots: int, m_r: int, *,
                      scheme: str = "uniform", max_len: int | None = None,
                      offset: int = 0) -> torch.Tensor:
    """(length, m_r) stacked ``decode_slots`` draws for positions offset ..
    offset + length - 1, on the host: row t is the draw the sequential decode
    loop makes at position offset + t."""
    if length == 0:
        return torch.zeros((0, m_r), dtype=torch.int32)
    return torch.stack([
        decode_slots(seed, offset + t, d_slots, m_r, scheme=scheme, max_len=max_len)
        for t in range(length)])


def make_seq_sketch(generator: torch.Generator, seq_len: int, d: int, m: int = 1, *,
                    local: bool = True, centers: torch.Tensor | None = None,
                    device="cuda") -> AccumSketch:
    """Accumulation sketch over sequence positions (prefill path), unsigned.

    ``local=True`` draws one uniform center per column and pools the m
    contiguous positions of the m-aligned window containing it (the chunk
    [m·⌊c/m⌋, m·⌊c/m⌋+m)): i.i.d. columns with correlated coordinates, which
    the paper's framework allows.  ``centers`` supplies the (d,) draw instead
    of the generator (parity with the reference feeds its draw here).
    ``local=False`` (or m = 1) is the i.i.d.-uniform unsigned sketch."""
    device = resolve_device(device)
    if not local or m == 1:
        return make_accum_sketch(generator, seq_len, d, m=m, signed=False, device=device)
    if centers is None:
        centers = torch.randint(0, seq_len, (d,), generator=generator,
                                device=generator.device)
    centers = torch.as_tensor(centers).to(device, torch.int64)
    start = (centers // m) * m
    indices = (start[None, :] + torch.arange(m, device=device)[:, None]) % seq_len
    probs = torch.full((seq_len,), 1.0 / seq_len, dtype=torch.float32, device=device)
    signs = torch.ones((m, d), dtype=torch.float32, device=device)
    indices = indices.to(torch.int32)
    return AccumSketch(indices=indices, signs=signs, probs=probs, n=seq_len,
                       coef_=signs / torch.sqrt(d * m * probs[indices.long()]))
