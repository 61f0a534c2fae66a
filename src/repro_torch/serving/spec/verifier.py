"""Batched verify pass and exact acceptance for speculative decoding.

``Verifier.verify`` scores every drafted token of the speculating batch in
ONE multi-token forward through the trusted backend (``lm.paged_verify``),
which also overwrites the draft's approximate K/V with exact values.

``Verifier.accept`` is the host-side acceptance rule per request:

  greedy     — accept draft d_j while it equals argmax(target_j); emit the
               corrected argmax at the first mismatch, or the bonus argmax
               when everything matched: token-identical to non-speculative
               greedy decoding.
  stochastic — exact rejection sampling: accept d_j with probability
               min(1, p_j(d_j) / q_j(d_j)); at the first rejection resample
               from norm(max(p_j - q_j, 0)); if all drafts are accepted,
               draw the bonus token from p_k. p and q come from
               ``sampling.filter_logits``, the non-speculative sampler's own
               truncation, so the output distribution is exactly that of
               non-speculative decoding.

Draws use per-(request, position, stream) threefry keys derived from the
request's base key (``repro/serving/spec/verifier.py``), so a seeded
speculative request gives the JAX engine's tokens and does not depend on
batch composition.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import lm
from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving.request import Request


class Verifier:
    """One batched trusted-path forward over drafted chunks + acceptance."""

    def __init__(self, cfg_verify: ModelConfig):
        self.cfg = cfg_verify

    def verify(self, params, pools: Dict, bt: torch.Tensor,
               start: torch.Tensor, num_new: torch.Tensor, toks: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict]:
        """toks (B, k+1): last committed token + drafts per row; start (B,)
        committed cache lengths; num_new (B,) valid chunk lengths (k_eff +
        1; 0 for padded rows). Returns (float32 logits (B, k+1, V), pools);
        row j scores the token after position start + j."""
        logits, pools = lm.paged_verify(params, pools, bt, start, num_new,
                                        toks, self.cfg)
        return logits.float(), pools

    @staticmethod
    def _dists(logits_rows: np.ndarray, sp) -> np.ndarray:
        """The request's sampling distributions over a stack of positions,
        through the non-speculative sampler's truncation, in float64."""
        n = logits_rows.shape[0]
        masked = sampling_mod.filter_logits(
            torch.from_numpy(np.ascontiguousarray(logits_rows)),
            torch.full((n,), sp.temperature, dtype=torch.float32),
            torch.full((n,), sp.top_k, dtype=torch.int32),
            torch.full((n,), sp.top_p, dtype=torch.float32))
        return torch.softmax(masked, dim=-1).numpy().astype(np.float64)

    @staticmethod
    def _draw(key: torch.Tensor, dist: np.ndarray) -> int:
        """``categorical(key, log(dist))`` with the distribution rounded to
        float32 first, as the JAX verifier hands it to jax."""
        probs = torch.from_numpy(np.maximum(dist, 1e-38).astype(np.float32))
        return int(sampling_mod.categorical(key, sampling_mod.log(probs)))

    def accept(self, req: Request, k_eff: int, draft_toks: np.ndarray,
               draft_logits: np.ndarray, target_logits: np.ndarray
               ) -> Tuple[List[int], int]:
        """Acceptance rule for one request.

        draft_toks (k_eff,); draft_logits (k_eff, V) the draft-path logits
        that produced them; target_logits (k_eff + 1, V) trusted-path
        logits. Returns (emitted tokens, number accepted): the accepted
        draft prefix plus exactly one trusted-path token (correction or
        bonus), so every speculative step emits at least one token."""
        if req.sampling.greedy:
            tgt = np.argmax(target_logits, axis=-1)
            emitted: List[int] = []
            for j in range(k_eff):
                if int(draft_toks[j]) != int(tgt[j]):
                    emitted.append(int(tgt[j]))
                    return emitted, j
                emitted.append(int(draft_toks[j]))
            emitted.append(int(tgt[k_eff]))
            return emitted, k_eff

        sp = req.sampling
        base = req.base_key.cpu()
        pos0 = len(req.output_tokens)
        p_all = self._dists(target_logits, sp)         # (k_eff + 1, V)
        q_all = self._dists(draft_logits, sp)          # (k_eff, V)
        emitted = []
        for j in range(k_eff):
            d = int(draft_toks[j])
            p, q = p_all[j], q_all[j]
            u = float(sampling_mod.uniform(sampling_mod.spec_key(
                base, pos0 + j, sampling_mod.STREAM_ACCEPT)))
            # accept with prob min(1, p(d)/q(d)); q(d) > 0 since d ~ q
            if u * q[d] <= p[d]:
                emitted.append(d)
                continue
            residual = np.maximum(p - q, 0.0)
            total = residual.sum()
            dist = residual / total if total > 0 else p
            emitted.append(self._draw(sampling_mod.spec_key(
                base, pos0 + j, sampling_mod.STREAM_RESAMPLE), dist))
            return emitted, j
        emitted.append(self._draw(sampling_mod.spec_key(
            base, pos0 + k_eff, sampling_mod.STREAM_RESAMPLE), p_all[k_eff]))
        return emitted, k_eff
