"""Batched serving engine: prefill + greedy/temperature decode loop
(counterpart of ``repro/serve/engine.py``).

The model owns its weights (an ``nn.Module``), so the engine holds no
``params``; the loop, the EOS rules and the skipped last decode are the
reference's; ``rolling`` decodes from the mod-W cache of ``cache_size``
slots, which the prefill fills with the prompt's last positions.  A batch's
extra inputs (``patch_embeds``, ``enc_embeds``) pass to the model's prefill
with the tokens, which moves them all to its device.
Temperature sampling draws from a ``torch.Generator`` seeded
from ``seed``: it cannot give ``jax.random``'s tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

__all__ = ["ServeEngine"]


@dataclass
class ServeEngine:
    model: Any
    cache_size: int
    rolling: bool = False

    def generate(
        self,
        batch: dict,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: int | None = None,
        truncate_done: bool = False,
    ) -> np.ndarray:
        """batch: {"tokens": (B, S)[, "patch_embeds" / "enc_embeds"]} ->
        (B, max_new_tokens) generated ids (greedy if temperature == 0).

        When every row has emitted ``eos_id`` the decode loop stops early,
        but the result is still padded to ``max_new_tokens`` with ``eos_id``
        so the output shape depends only on the arguments.
        ``truncate_done=True`` cuts it after the step where the last row
        finished instead."""
        logits, caches, cache_len = self.model.prefill(
            batch, cache_size=self.cache_size)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=logits.device).manual_seed(seed)
        b = logits.shape[0]
        out = np.zeros((b, max_new_tokens), dtype=np.int32)
        done = np.zeros(b, dtype=bool)
        for t in range(max_new_tokens):
            if gen is not None:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            tok_np = tok.cpu().numpy().astype(np.int32)
            if eos_id is not None:
                # rows that already emitted EOS are finished: freeze every
                # later position to eos_id instead of resampling over it
                tok_np = np.where(done, eos_id, tok_np)
            out[:, t] = tok_np
            if eos_id is not None:
                done |= tok_np == eos_id
                if done.all():
                    if truncate_done:
                        out = out[:, : t + 1]
                    else:
                        out[:, t + 1:] = eos_id
                    break
            if t + 1 < max_new_tokens:   # the last token needs no decode
                token = torch.as_tensor(tok_np, device=logits.device)[:, None]
                logits, caches = self.model.decode_step(
                    token, caches, cache_len, rolling=self.rolling)
                cache_len = cache_len + 1
        return out
