"""Minimal batched serving engine.

The PyTorch counterpart of ``repro.serve.engine``, quirks included: prefill
feeds the prompt through the decode step one token at a time (populating
the KV cache token by token; it never takes the flash path and does not
keep its logits), so ``generate`` after a prefill starts from token 0.  It
emits the same ``serve.prefill`` / ``serve.generate`` spans and
``serve.tokens.{prefill,decode}`` counters.

It holds any family's decode state (``backbone.init_decode_state``).  For
the audio family the caller sets ``engine.state["enc"]`` to the encoder's
output (``backbone._run_encoder``) before the prefill, as with the
reference's engine.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.models import backbone
from repro_torch.models.config import ArchConfig

from .serve_step import make_decode_step, sample_token


class ServeEngine:
    def __init__(self, cfg: ArchConfig, model, *, batch: int, kv_len: int, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.batch = batch
        self.kv_len = kv_len
        self.device = torch.device(device)
        self.state = backbone.init_decode_state(cfg, batch, kv_len, device=self.device)
        self._step = make_decode_step(cfg, device=self.device)
        self.position = 0

    def prefill(self, prompts) -> torch.Tensor:
        """prompts (B, S) int; feeds them through decode steps.  Returns the
        last step's logits (B, padded_vocab) in f32."""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s = prompts.shape
        assert b == self.batch
        with obs.span("serve.prefill", cat="serve", arch=self.cfg.name,
                      batch=b, tokens=int(s), position=self.position):
            logits = torch.zeros((b, self.cfg.padded_vocab), dtype=torch.float32,
                                 device=self.device)
            for t in range(s):
                step_logits, self.state = self._step(
                    self.model, self.state, prompts[:, t][:, None], t + self.position)
                logits = step_logits.float()
            self.position += s
            obs.counter_add("serve.tokens.prefill", b * int(s))
        return logits

    def generate(self, n_tokens: int, generator: torch.Generator | None = None,
                 temperature: float = 0.0) -> torch.Tensor:
        """``n_tokens`` decode steps; returns the sampled tokens (B, n) int32."""
        logits = torch.zeros((self.batch, self.cfg.padded_vocab), dtype=torch.float32,
                             device=self.device)
        last = getattr(self, "_last_logits", None)
        tok = (
            sample_token(generator, last, temperature)
            if last is not None
            else torch.zeros((self.batch,), dtype=torch.int32, device=self.device)
        )
        out = []
        with obs.span("serve.generate", cat="serve", arch=self.cfg.name,
                      batch=self.batch, tokens=n_tokens, temperature=temperature):
            for _ in range(n_tokens):
                logits, self.state = self._step(
                    self.model, self.state, tok[:, None], self.position)
                tok = sample_token(generator, logits, temperature)
                out.append(tok)
                self.position += 1
            obs.counter_add("serve.tokens.decode", self.batch * n_tokens)
        self._last_logits = logits
        return torch.stack(out, dim=1)
