"""Serving engine: batched prefill + decode with exact or AccumSketch caches
(ported from ``repro.serve.engine``).

The sketched cache (paper technique) makes per-request memory independent of
context length: decode attends over d_slots landmark slots instead of a
cache that grows with the context.

Request lifecycle:

  prefill  — ``prefill_with_cache``: all L prompt tokens in one chunked
             forward with a bulk cache write (sketched: the fold of all L
             tokens, bitwise the token-by-token loop's cache);
  decode   — a Python loop of exactly n_new − 1 ``decode_step`` calls (token
             0 is sampled from the prefill logits).  Tokens stay on the
             device until the end of a chunk.

Slot draws and temperature sampling come from independent streams, (seed,
``SLOT_STREAM``) and (seed, ``SAMPLE_STREAM``), each folded with the
position, so every draw is a pure function of (seed, position).

Resilience: with ``ckpt_dir`` set and a ``request_id`` passed to
``generate()``, the decode loop runs in chunks of ``ckpt_every`` steps and
checkpoints (cache, emitted tokens) after each chunk; the snapshot plus the
emitted count is the whole resume state, so a generate() killed mid-decode
and resumed emits bitwise-identical tokens.  With ``health_check`` on, the
cache is screened for non-finite values / mass underflow between chunks
(one host read); a poisoned sketched cache degrades to exact attention by
re-prefilling the emitted history, recorded in ``Engine.health``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any

import numpy as np
import torch

from repro_torch._util import SAMPLE_STREAM, position_generator, tree_leaves
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sketched_attention import SketchCache, decode_slot_table, decode_slots
from repro_torch.models.model import DecodeCache, decode_step, init_cache, prefill_with_cache
from repro_torch.resilience import faults
from repro_torch.resilience.degrade import HealthReport


def _prompt_digest(prompts: np.ndarray) -> str:
    a = np.ascontiguousarray(np.asarray(prompts))
    return hashlib.sha256(a.tobytes() + str(a.shape).encode()).hexdigest()[:16]


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs (cache flavor, sampling, slot-draw scheme, resilience).

    ``slot_scheme``: "uniform" | "poisson" (see ``decode_slots``).
    ``cache_dtype`` applies to exact KV caches and to the sketched k/v slot
    sums (mass stays float32).  When ``max_len <= cfg.sketch_attn.d_slots``
    the slot draw is the identity and sketched decode is exact attention.
    ``ckpt_dir`` + a ``request_id`` arm checkpoint/resume, ``ckpt_every``
    sets the decode chunk between snapshots (0 → one chunk), ``keep_last``
    bounds retained history, ``health_check`` screens the cache between
    chunks."""

    max_len: int = 2048
    use_sketch: bool = False
    temperature: float = 0.0        # 0 → greedy
    seed: int = 0
    slot_scheme: str = "uniform"
    cache_dtype: Any = torch.bfloat16
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    keep_last: int = 3
    health_check: bool = True


class Engine:
    """Single-device engine; runs where ``params`` live."""

    def __init__(self, cfg: ModelConfig, params: dict, sc: ServeConfig):
        self.cfg, self.params, self.sc = cfg, params, sc
        self.device = params["embed"].device
        self.health = HealthReport()

    def new_cache(self, batch: int, use_sketch: bool | None = None) -> DecodeCache:
        """Fresh decode cache (exact KV or sketched per ``sc.use_sketch``;
        ``use_sketch`` overrides — the degrade and resume paths build exact
        caches from a sketched engine)."""
        if use_sketch is None:
            use_sketch = self.sc.use_sketch
        return init_cache(self.cfg, batch, self.sc.max_len, self.sc.cache_dtype,
                          use_sketch=use_sketch, device=self.device)

    def stats(self) -> dict:
        """Engine health surface: degradation/resume events recorded so far."""
        return {"health_events": self.health.count(), "health": self.health.summary()}

    def _slots(self, pos: int) -> torch.Tensor:
        sa = self.cfg.sketch_attn
        return decode_slots(self.sc.seed, pos, sa.d_slots, sa.m_r,
                            scheme=self.sc.slot_scheme, max_len=self.sc.max_len)

    def _slot_table(self, length: int) -> torch.Tensor:
        sa = self.cfg.sketch_attn
        return decode_slot_table(self.sc.seed, length, sa.d_slots, sa.m_r,
                                 scheme=self.sc.slot_scheme, max_len=self.sc.max_len)

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long).to(self.device)

    def prefill_tokens(self, cache: DecodeCache, prompts: np.ndarray
                       ) -> tuple[DecodeCache, torch.Tensor]:
        """Batched prefill of all L prompt tokens (positions 0..L-1).
        prompts: (B, L).  Returns (cache, last-position logits)."""
        table = self._slot_table(prompts.shape[1]) if self.sc.use_sketch else None
        logits, cache = prefill_with_cache(self.params, self._tokens(prompts), self.cfg,
                                           cache, slot_table=table)
        return cache, logits

    def prefill_tokens_sequential(self, cache: DecodeCache, prompts: np.ndarray
                                  ) -> tuple[DecodeCache, torch.Tensor]:
        """Token-by-token decode-mode prefill (L decode steps) — the
        equivalence oracle for the batched prefill.  prompts: (B, L)."""
        tokens = self._tokens(prompts)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = decode_step(self.params, cache, tokens[:, t], t, self.cfg,
                                        slots=self._slots(t))
        return cache, logits

    def _decode_loop(self, cache: DecodeCache, tok0: torch.Tensor, pos0: int,
                     n_steps: int) -> tuple[torch.Tensor, DecodeCache]:
        """n_steps decode steps + samples, the tokens left on the device
        ((B, n_steps)): the loop reads nothing back on the host (the
        trace contracts ``engine_decode`` and ``engine_decode_degraded``)."""
        tok, toks = tok0, []
        for pos in range(pos0, pos0 + n_steps):
            logits, cache = decode_step(self.params, cache, tok, pos, self.cfg,
                                        slots=self._slots(pos))
            tok = self._sample(logits, pos + 1)
            toks.append(tok)
        return torch.stack(toks, dim=1), cache

    def _decode(self, cache: DecodeCache, tok0: torch.Tensor, pos0: int, n_steps: int
                ) -> tuple[np.ndarray, DecodeCache]:
        """``_decode_loop``; the tokens come to the host once."""
        toks, cache = self._decode_loop(cache, tok0, pos0, n_steps)
        return toks.cpu().numpy().astype(np.int32), cache

    # ---------------------------------------------------------------- resume

    def _request_extra(self, prompts, use_sketch: bool, n_emitted: int) -> dict:
        return {"prompt_sha": _prompt_digest(prompts), "seed": self.sc.seed,
                "slot_scheme": self.sc.slot_scheme, "max_len": self.sc.max_len,
                "temperature": self.sc.temperature, "use_sketch": bool(use_sketch),
                "n_emitted": int(n_emitted)}

    def _save_request(self, ckdir: str, cache, toks_done, use_sketch, prompts) -> None:
        ckpt.save(ckdir, {"cache": cache, "toks": np.asarray(toks_done, np.int32)},
                  step=int(toks_done.shape[1]),
                  extra=self._request_extra(prompts, use_sketch, toks_done.shape[1]),
                  keep_last=self.sc.keep_last)

    def _try_resume(self, ckdir: str, prompts: np.ndarray):
        """Load the newest usable request checkpoint, checking that it was
        written for this exact (prompts, seed, scheme, max_len, temperature):
        anything else would break the bitwise guarantee, so a mismatch
        raises.  A corrupt newest step falls back to the prior one."""
        B = prompts.shape[0]
        steps = ckpt.committed_steps(ckdir)
        digest = _prompt_digest(prompts)
        for i, s in enumerate(steps):
            try:
                extra = ckpt.read_meta(ckdir, s)["extra"]
            except Exception as e:  # noqa: BLE001 — unreadable meta == corrupt step
                self._record_skip(steps, i, e)
                continue
            fields = ("seed", "slot_scheme", "max_len", "temperature")
            want = self._request_extra(prompts, extra.get("use_sketch", False), 0)
            if extra.get("prompt_sha") != digest or any(
                    extra.get(f) != want[f] for f in fields):
                raise ValueError(
                    f"checkpoint {ckdir}/step_{s} was written for a different request "
                    "or engine config; refusing to resume (the bitwise guarantee "
                    "would not hold)")
            use_sketch = bool(extra.get("use_sketch", self.sc.use_sketch))
            like = {"cache": self.new_cache(B, use_sketch=use_sketch),
                    "toks": np.zeros((B, 1), np.int32)}
            try:
                state, _ = ckpt.restore(ckdir, like, step=s)
            except Exception as e:  # noqa: BLE001 — corrupt payload: try step N−1
                self._record_skip(steps, i, e)
                continue
            toks = np.asarray(state["toks"], np.int32)
            self.health.record("ckpt.resume", rung_from="cold", rung_to=f"step_{s}",
                               detail=f"resumed with {toks.shape[1]} tokens emitted")
            return state["cache"], toks, use_sketch
        return None

    def _record_skip(self, steps, i, err) -> None:
        nxt = f"step_{steps[i + 1]}" if i + 1 < len(steps) else "none"
        self.health.record("ckpt.restore", rung_from=f"step_{steps[i]}", rung_to=nxt,
                           detail=repr(err))

    # ------------------------------------------------------------ health

    def _cache_bad(self, cache: DecodeCache, use_sketch: bool) -> str:
        """Screen the cache between decode chunks (one host read).  Returns a
        reason string, or "" when healthy."""
        leaves = [x for x in tree_leaves(cache) if x.is_floating_point()]
        bad = torch.stack([(~torch.isfinite(x)).sum() for x in leaves]).sum()
        sketched = [st for states in cache.blocks.values() for st in states
                    if isinstance(st, SketchCache)]
        low = (torch.stack([st.mass.float().sum(-1).min() for st in sketched]).min()
               if use_sketch and sketched else torch.ones((), device=bad.device))
        vals = torch.stack([bad.float(), low.float()]).cpu()
        n_bad, low = int(vals[0]), float(vals[1])
        if n_bad:
            return f"{n_bad} non-finite cache entries"
        if low <= 0.0:
            return "sketched cache mass underflow"
        return ""

    def _rebuild_exact(self, prompts: np.ndarray, toks_done: np.ndarray) -> DecodeCache:
        """Exact-attention degrade: re-prefill prompt + emitted history into a
        fresh exact KV cache (correctness kept; only the flat-memory property
        is given up for this request)."""
        hist = np.concatenate([np.asarray(prompts), np.asarray(toks_done[:, :-1])], axis=1)
        cache = self.new_cache(prompts.shape[0], use_sketch=False)
        _, cache = prefill_with_cache(self.params, self._tokens(hist), self.cfg, cache)
        return cache

    # ---------------------------------------------------------------- serve

    def generate(self, prompts: np.ndarray, n_new: int, *, request_id: str | None = None
                 ) -> tuple[np.ndarray, DecodeCache]:
        """Prefill ``prompts`` (B, L) and generate n_new tokens per sequence.

        Token 0 is sampled from the prefill logits; the loop then runs exactly
        n_new − 1 decode steps.  Returns ((B, n_new) int32, cache).  With
        ``sc.ckpt_dir`` set and a ``request_id``, progress is checkpointed
        every ``sc.ckpt_every`` tokens and an interrupted request resumes
        from <ckpt_dir>/<request_id> with bitwise-identical output."""
        prompts = np.asarray(prompts)
        B, L = prompts.shape
        use_sketch = self.sc.use_sketch
        ckdir = (os.path.join(self.sc.ckpt_dir, str(request_id))
                 if self.sc.ckpt_dir and request_id is not None else None)
        resumed = self._try_resume(ckdir, prompts) if ckdir else None
        if resumed is not None:
            cache, toks_done, use_sketch = resumed
        else:
            cache, logits = self.prefill_tokens(self.new_cache(B), prompts)
            toks_done = self._sample(logits, L).cpu().numpy().astype(np.int32)[:, None]
            if ckdir:
                self._save_request(ckdir, cache, toks_done, use_sketch, prompts)
        while toks_done.shape[1] < n_new:
            emitted = toks_done.shape[1]
            remaining = n_new - emitted
            chunk = remaining if self.sc.ckpt_every <= 0 else min(self.sc.ckpt_every,
                                                                  remaining)
            # fault site: one arrival per decode chunk ("kill" dies here;
            # "nan"/"inf"/"zero" poison the cache the health screen must catch)
            cache = faults.poison("decode.step", cache)
            if self.sc.health_check:
                reason = self._cache_bad(cache, use_sketch)
                if reason:
                    self.health.record("decode.cache",
                                       rung_from="sketched" if use_sketch else "exact",
                                       rung_to="exact-rebuild", detail=reason)
                    cache = self._rebuild_exact(prompts, toks_done)
                    use_sketch = False
            toks, cache = self._decode(cache, self._tokens(toks_done[:, -1]),
                                       L + emitted - 1, chunk)
            toks_done = np.concatenate([toks_done, toks], axis=1)
            if ckdir:
                self._save_request(ckdir, cache, toks_done, use_sketch, prompts)
        return toks_done[:, :n_new], cache

    def _sample(self, logits: torch.Tensor, pos: int) -> torch.Tensor:
        """Greedy argmax, or a Gumbel-max draw from softmax(logits / T) with
        the uniforms of the stream (seed, SAMPLE_STREAM) at ``pos``."""
        if self.sc.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        g = position_generator(self.sc.seed, SAMPLE_STREAM, pos)
        u = torch.rand(logits.shape, generator=g, dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny).to(logits.device, non_blocking=True)
        return torch.argmax(logits.float() / self.sc.temperature - torch.log(-torch.log(u)),
                            dim=-1)
