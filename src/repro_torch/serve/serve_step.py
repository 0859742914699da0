"""Serving steps.

* ``prefill_step`` — full-sequence forward over the prompt (through the
  flash kernel on a CUDA device): returns next-token logits.
* ``serve_step`` — one new token against the decode state of
  ``backbone.init_decode_state`` (KV caches, SSM states), which it updates.

The PyTorch counterpart of ``repro.serve.serve_step``.  Each step checks
that the model lies on the step's device, moves the tokens there, and runs
under ``torch.no_grad``.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist.sharding import Rules, axis_rules, current_rules, is_dtensor, use_mesh
from repro_torch.models import backbone
from repro_torch.models.config import ArchConfig
from repro_torch.models.weights import shard_model


def _on(model, device: torch.device) -> None:
    got = model.embed.w.device
    if got.type != device.type or (device.index is not None and got != device):
        raise ValueError(f"the model lies on {got}, the step runs on {device}")


def make_prefill_step(cfg: ArchConfig, chunk: int = 512, *, device="cuda",
                      use_flash: bool | None = None, mesh=None, rules: Rules | None = None):
    """``prefill_step(model, batch) -> logits (B, padded_vocab)`` at the last
    position.  ``batch`` holds ``tokens`` and, where the family takes them,
    ``vis_embeds`` (vlm) or ``frames`` (audio); each is moved to the step's
    device.  ``use_flash=None`` takes the flash kernel on a CUDA device.

    With ``mesh`` (a ``DeviceMesh`` of the whole world, every rank calling
    the step with the same batch) the model is laid out over it under
    ``rules`` (the ambient ones by default) at its first step, and each step
    runs under ``use_mesh(mesh)`` and ``axis_rules(rules)``: the logits are
    a DTensor (``full_tensor()`` gathers them)."""
    device = torch.device(device)
    rules = current_rules() if rules is None else rules

    @torch.no_grad()
    def prefill_step(model, batch):
        _on(model, device)
        batch = {key: torch.as_tensor(val, device=device) for key, val in batch.items()}
        with contextlib.ExitStack() as scope:
            if mesh is not None:
                scope.enter_context(use_mesh(mesh))
                scope.enter_context(axis_rules(rules))
                if not is_dtensor(model.embed.w):
                    shard_model(model, mesh)
            logits, _ = backbone.forward(model, cfg, batch, chunk=chunk, use_flash=use_flash)
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, device="cuda", mesh=None, rules: Rules | None = None):
    """``serve_step(model, state, tokens (B, 1), position) -> (logits (B, V),
    state)``; the state's caches are written in place.

    With ``mesh`` the model is laid out over it under ``rules`` (the ambient
    ones by default) at its first step, and each step runs under
    ``use_mesh(mesh)`` and ``axis_rules(rules)`` on a state laid out over it
    (``backbone.init_decode_state(..., mesh=)``): the logits are a DTensor
    (``full_tensor()`` gathers them)."""
    device = torch.device(device)
    rules = current_rules() if rules is None else rules

    @torch.no_grad()
    def serve_step(model, state, tokens, position: int):
        _on(model, device)
        tokens = torch.as_tensor(tokens, device=device)
        with contextlib.ExitStack() as scope:
            if mesh is not None:
                scope.enter_context(use_mesh(mesh))
                scope.enter_context(axis_rules(rules))
                if not is_dtensor(model.embed.w):
                    shard_model(model, mesh)
            logits, state = backbone.decode_step(model, cfg, state, tokens, position)
        return logits[:, -1, :], state

    return serve_step


def sample_token(generator: torch.Generator | None, logits: torch.Tensor,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy at temperature 0 (first index of the max, as ``jnp.argmax``);
    otherwise a draw from ``softmax(logits / temperature)`` with
    ``generator``, which cannot reproduce ``jax.random.categorical``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
