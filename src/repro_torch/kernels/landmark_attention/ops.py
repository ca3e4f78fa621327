"""Padded entry points for the landmark-attention kernels.

Each wrapper chooses by device alone: a tensor on the CPU takes the plain
PyTorch version (``ref``), a tensor on a CUDA device launches the CUDA
kernel (``kernel``), whose failures propagate.  As in the reference's ops,
the landmark axis of ``landmark_attend`` is padded to a multiple of 8 with
−1e30 bias, so a padded landmark carries zero weight wherever a real one
carries any.  Query rows and keys are not padded: the kernels mask their
own ragged edges.  The rows a block come from the measured autotune cache
of the accum_apply kernels (``autotune``), under the reference's kinds
``landmark_attention`` (bq) and ``landmark_stats`` (bs): the first CUDA call
at a key times the candidates the device can launch (``kernel.fits``) and
persists the winner, keyed by the hash of ``csrc/landmark_attention.cu``
(``kernel.source_hash``) so that no geometry outlives a redesign of the
source; without a measurement the static geometry that fits
(``kernel.static_rows``) launches.  The key tile and splits are fixed by
the shape, so every candidate gives the same bits.

``accum_attention_kernel`` is the full pipeline: landmark pools, then ONE
fused sweep over S (``landmark_stats``: W and the online-softmax Bm·V, the
(L, S) Bm matrix never built), then the Newton–Schulz W⁺ in plain torch,
then the O(S·L) F-stage (``landmark_attention``).
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.sketch import AccumSketch
from repro_torch.kernels import routed
from repro_torch.kernels.accum_apply import autotune
from repro_torch.kernels.landmark_attention import kernel as K_
from repro_torch.kernels.landmark_attention import ref
from repro_torch.resilience import faults

NEG_INF = ref.NEG_INF


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _batched(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x if x.ndim == ndim else x[None]


def _bq_candidates(S: int, fallback: tuple[int], Dh: int, dtype: torch.dtype,
                   out_dtype: torch.dtype, device) -> list[tuple[int]]:
    """The fallback first, then the other rows a block the sweep over S rows
    takes (``kernel.block_rows``: 8 alone where S ≤ 8, else 64 and 128);
    each kept only where it fits the device."""
    rows = (fallback[0], *K_.block_rows(S))
    return [(b,) for b in dict.fromkeys(rows)
            if K_.fits(b, Dh, dtype, out_dtype, device)]


@routed
def landmark_attend(q: torch.Tensor, kt: torch.Tensor, M: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k̃ᵀ/√Dh + bias)·M for arbitrary (S, L).

    q: (S, Dh) or (P, S, Dh); kt: (…, L, Dh); M: (…, L, Dv); bias: (…, L)
    float32 or None (the decode path folds its log-mass correction and
    empty-slot masks in here).  Returns (…, S, Dv) in q's dtype."""
    single = q.ndim == 2
    q, kt, M = _batched(q, 3), _batched(kt, 3), _batched(M, 3)
    P, L = M.shape[:2]
    pad = (-L) % 8
    if bias is not None:
        bias = _batched(bias, 2).float()
    if pad:
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
        M = torch.nn.functional.pad(M, (0, 0, 0, pad))
        if bias is None:
            bias = torch.zeros((P, L), dtype=torch.float32, device=q.device)
        bias = torch.nn.functional.pad(bias, (0, pad), value=NEG_INF)
    if not _on_cuda(q):
        out = ref.landmark_attention_ref(q, kt, M, bias)
        return out[0] if single else out
    args = (q.contiguous(), kt.to(q.dtype).contiguous(), M.to(q.dtype).contiguous(),
            None if bias is None else bias.contiguous())
    if is_fake(q):
        # a dry run (launch.dryrun): shapes only — nothing launches, and the
        # autotune cache is not consulted
        out = _dry_run_op()(*args)
        return out[0] if single else out
    S, Dh = q.shape[1:]
    fb = (K_.static_rows(S, Dh, q.dtype, q.dtype, q.device),)
    (bq,) = autotune.measured_blocks(
        "landmark_attention", (P, S, Dh, M.shape[1], M.shape[2]), q.dtype, q.device,
        _bq_candidates(S, fb, Dh, q.dtype, q.dtype, q.device),
        lambda c: K_.landmark_attention(*args, bq=c[0]), fb,
        concrete=autotune.is_concrete(*args[:3]), source=K_.source_hash())
    out = K_.landmark_attention(*args, bq=bq)
    return out[0] if single else out


@functools.cache
def _dry_run_op():
    """The kernel's stand-in on fake tensors (``FakeTensorMode``: the dry
    run's abstract values), made at its first use: the custom op
    ``repro_torch::landmark_attention``, whose fake implementation gives the
    output's shape and dtype (the plain version's), so that one rank's
    recording charges it the kernel's operand and result bytes, and whose
    FLOP formula (``torch.utils.flop_counter``) gives the two products the
    kernel computes, 2·P·S·L·Dh + 2·P·S·L·Dv (the plain version's).  It
    never computes: on a real tensor it raises (a real CUDA tensor launches
    the kernel)."""
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::landmark_attention", mutates_args=())
    def op(q: torch.Tensor, kt: torch.Tensor, M: torch.Tensor,
           bias: torch.Tensor | None) -> torch.Tensor:
        raise RuntimeError("landmark_attention's dry-run stand-in takes fake tensors only")

    @op.register_fake
    def _(q, kt, M, bias):
        return q.new_empty((*q.shape[:-1], M.shape[-1]))

    @register_flop_formula(torch.ops.repro_torch.landmark_attention)
    def _(q_shape, kt_shape, M_shape, bias_shape, out_shape=None, **kw) -> int:
        (P, S, Dh), L, Dv = q_shape, kt_shape[1], M_shape[2]
        return 2 * P * S * L * (Dh + Dv)

    return torch.ops.repro_torch.landmark_attention


@routed
def landmark_stats_fused(qt: torch.Tensor, kt: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (W, Bm·V) for arbitrary (S, L): qt, kt (…, L, Dh); k (…, S, Dh);
    v (…, S, Dv), with (…) empty or one batch axis.  One sweep over S
    computes both the landmark-row softmax W = softmax(q̃k̃ᵀ) and the
    online-softmax accumulation of softmax(q̃Kᵀ)·V.  Returns (W (…, L, L),
    BmV (…, L, Dv)) float32."""
    single = qt.ndim == 2
    qt, kt, k, v = (_batched(x, 3) for x in (qt, kt, k, v))
    if not _on_cuda(qt):
        W, BmV = ref.landmark_stats_ref(qt, kt, k, v)
        return (W[0], BmV[0]) if single else (W, BmV)
    dt = qt.dtype
    args = (qt.contiguous(), kt.to(dt).contiguous(), k.to(dt).contiguous(),
            v.to(dt).contiguous())
    (P, L, Dh), (S, Dv) = qt.shape, v.shape[1:]
    fb = (K_.static_rows(L, Dh, dt, torch.float32, qt.device, "landmark_stats"),)
    (bs,) = autotune.measured_blocks(
        "landmark_stats", (P, S, Dh, L, Dv), dt, qt.device,
        _bq_candidates(L, fb, Dh, dt, torch.float32, qt.device),
        lambda c: K_.landmark_stats(*args, bs=c[0]), fb,
        concrete=autotune.is_concrete(*args), source=K_.source_hash())
    W, BmV = K_.landmark_stats(*args, bs=bs)
    return (W[0], BmV[0]) if single else (W, BmV)


@routed
def accum_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           sk: AccumSketch, *, pinv_iters: int = 6) -> torch.Tensor:
    """Full sketched attention (B, H, S, Dh) with both O(S·L) stages in the
    kernels (matching ``core.sketched_attention.accum_attention``):

      k̃/q̃ = landmark pools;
      (W, BmV) = ``landmark_stats`` — ONE fused sweep over S;
      M = W⁺ · BmV  [small L×L, plain torch Newton–Schulz];
      out = softmax(Q K̃ᵀ)·M — ``landmark_attention``, O(S·L).

    This entry visits the ``kernel.dispatch`` fault site: an injected error
    raises to the caller.  It never degrades to the plain route."""
    from repro_torch.core.sketched_attention import _newton_schulz_pinv, landmark_pool

    faults.fault_point("kernel.dispatch")
    kt = landmark_pool(k, sk, normalize=True)
    qt = landmark_pool(q, sk, normalize=True)
    B, H = q.shape[:2]

    def flat(x):
        return x.reshape((B * H,) + x.shape[2:])

    W, BmV = landmark_stats_fused(flat(qt), flat(kt), flat(k), flat(v))
    M = _newton_schulz_pinv(W, pinv_iters) @ BmV                    # (BH, L, Dv)
    out = landmark_attend(flat(q), flat(kt), M.to(q.dtype))
    return out.reshape(q.shape[:2] + out.shape[1:])
