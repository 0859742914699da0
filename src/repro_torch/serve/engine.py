"""Minimal batched serving engine.

The PyTorch counterpart of ``repro.serve.engine``, quirks included: prefill
feeds the prompt through the decode step one token at a time (populating
the KV cache token by token; it never takes the flash path and does not
keep its logits), so ``generate`` after a prefill starts from token 0.  It
emits the same ``serve.prefill`` / ``serve.generate`` spans and
``serve.tokens.{prefill,decode}`` counters.

It holds any family's decode state (``backbone.init_decode_state``).  For
the audio family the caller sets ``engine.state["enc"]`` to the encoder's
output before the prefill, as with the reference's engine: ``encode(frames)``
runs the encoder and sets it, laid out as the state.

With a ``mesh`` (any family) the model and the state are laid out over it
under ``rules`` and every step runs sharded (``make_decode_step(...,
mesh=)``); the logits a step returns are gathered (``full_tensor()``), so
sampling and the returned logits and tokens are plain tensors, the same on
every rank.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import obs
from repro_torch.dist.sharding import Rules, axis_rules, current_rules, is_dtensor, use_mesh
from repro_torch.models import backbone
from repro_torch.models.config import ArchConfig

from .serve_step import make_decode_step, sample_token


def _gathered(logits: torch.Tensor) -> torch.Tensor:
    return logits.full_tensor() if is_dtensor(logits) else logits


class ServeEngine:
    def __init__(self, cfg: ArchConfig, model, *, batch: int, kv_len: int, device="cuda",
                 mesh=None, rules: Rules | None = None):
        self.cfg = cfg
        self.model = model
        self.batch = batch
        self.kv_len = kv_len
        self.device = torch.device(device)
        rules = current_rules() if rules is None else rules
        self.mesh, self.rules = mesh, rules
        with axis_rules(rules):
            self.state = backbone.init_decode_state(cfg, batch, kv_len, device=self.device,
                                                    mesh=mesh)
        self._step = make_decode_step(cfg, device=self.device, mesh=mesh, rules=rules)
        self.position = 0
        self.last_logits = None  # the last generate step's logits (B, padded_vocab)

    @torch.no_grad()
    def encode(self, frames) -> None:
        """The audio family: set the state's ``enc`` to the encoder's output
        over ``frames`` (B, encoder_seq, d), run over the engine's mesh where
        it has one."""
        frames = torch.as_tensor(frames, device=self.device)
        with obs.span("serve.encode", cat="serve", arch=self.cfg.name,
                      batch=int(frames.shape[0])), contextlib.ExitStack() as scope:
            if self.mesh is not None:
                scope.enter_context(use_mesh(self.mesh))
                scope.enter_context(axis_rules(self.rules))
            enc = backbone._run_encoder(self.model, self.cfg, frames)
            if is_dtensor(enc):  # laid out as the state's own
                enc = enc.redistribute(self.mesh, self.state["enc"].placements)
            self.state["enc"] = enc

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
                logits, self.state = self._step(
                    self.model, self.state, prompts[:, t][:, None], t + self.position)
            logits = _gathered(logits).float()
            self.position += s
            obs.counter_add("serve.tokens.prefill", b * int(s))
        return logits

    def generate(self, n_tokens: int, generator: torch.Generator | None = None,
                 temperature: float = 0.0) -> torch.Tensor:
        """``n_tokens`` decode steps; returns the sampled tokens (B, n) int32."""
        logits = torch.zeros((self.batch, self.cfg.padded_vocab), dtype=torch.float32,
                             device=self.device)
        last = self.last_logits
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
                logits = _gathered(logits)
                tok = sample_token(generator, logits, temperature)
                out.append(tok)
                self.position += 1
            obs.counter_add("serve.tokens.decode", self.batch * n_tokens)
        self.last_logits = logits
        return torch.stack(out, dim=1)
