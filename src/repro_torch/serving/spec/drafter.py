"""k-token autoregressive draft loop through the cheap sparse path.

``Drafter.draft`` runs ``k`` single-token ``lm.paged_decode_step`` calls
under the draft configuration (e.g. thresholded tile-skip) for the whole
speculating batch, as a Python loop where the JAX package scans. Each step's
token is chosen on the device (argmax, or ``sample_tokens`` with that
step's keys) and fed to the next step without a host round trip, so the
loop queues its work without waiting on the card.

Draft K/V land in scratch positions past each request's committed length,
inside its admission reservation; a row that drafts fewer than ``k``
tokens sends its surplus writes to the null block (``write_valid``). The
verifier rewrites every drafted position with exact values before anything
is committed, so the approximation only ever costs acceptance rate.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import lm
from repro_torch.serving import sampling as sampling_mod


class Drafter:
    """Runs the k-token draft loop under the draft backend's config."""

    def __init__(self, cfg_draft: ModelConfig, k: int):
        self.cfg = cfg_draft
        self.k = k

    def draft(self, params, pools: Dict, bt: torch.Tensor, sl0: torch.Tensor,
              tok0: torch.Tensor, draft_len: torch.Tensor, keys: torch.Tensor,
              temps: torch.Tensor, topks: torch.Tensor, topps: torch.Tensor,
              *, greedy: bool) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """Draft ``k`` tokens per row.

        bt (B, W) block tables; sl0 (B,) committed cache lengths; tok0
        (B, 1) last committed tokens; draft_len (B,) each row's draft budget
        (writes of steps >= draft_len go to the null block); keys (k, B, 2)
        draft keys (ignored when ``greedy``). Returns (draft tokens (B, k),
        draft logits (B, k, V), pools)."""
        tok = tok0
        toks, logits = [], []
        for j in range(self.k):
            out, pools = lm.paged_decode_step(
                params, pools, bt, sl0 + j, tok, self.cfg,
                write_valid=j < draft_len)
            last = out[:, -1]
            nxt = torch.argmax(last, dim=-1) if greedy else \
                sampling_mod.sample_tokens(last, keys[j], temps, topks, topps)
            toks.append(nxt)
            logits.append(last)
            tok = nxt[:, None]
        return torch.stack(toks, dim=1), torch.stack(logits, dim=1), pools
