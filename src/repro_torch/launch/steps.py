"""Step builders (train / prefill / serve) and input specs.

The one-device half of the JAX package's ``launch/steps.py``.  A step is a
plain function over the port's parameter and state trees: the train step
differentiates ``models.loss_fn`` with autograd and applies AdamW, the
prefill and serve steps emit the next token.  The reference's sharding
assignment and ``jitted_step_for_cell`` place each argument tree over a
device mesh: multi-device, ROADMAP.md item A16c.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as M
from ..optim import adamw
from ..sharding.rules import tree_leaves, tree_map


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one input (the reference's
    ``jax.ShapeDtypeStruct``); nothing is allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, TensorSpec]:
    """Model inputs for one step of the given shape cell.

    Train/prefill: the full sequence; frontend archs split the sequence
    into (frontend embeddings, text tokens) so total length == seq_len.
    Decode: a single new token (the KV cache is a separate argument)."""
    B = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), torch.int32)}
    F = cfg.frontend_len if cfg.frontend else 0
    S_text = shape.seq_len - F
    out = {"tokens": TensorSpec((B, S_text), torch.int32),
           "labels": TensorSpec((B, S_text), torch.int32)}
    if cfg.frontend:
        out["frontend_embeds"] = TensorSpec((B, F, cfg.d_model), dtype)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> Any:
    """The decode caches at this cell's length as a tree of
    :class:`TensorSpec` (built on the ``meta`` device: no memory)."""
    caches = M.init_caches(cfg, shape.global_batch, shape.seq_len, dtype,
                           device="meta")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), caches)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def value_and_grad(params: Any, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, list]:
    """Loss and the gradient of every parameter leaf (leaf order of
    ``params``); the parameters themselves are not marked."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        loss = M.loss_fn(tree_map(lambda _: next(it), params), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, mixed_precision: bool = False,
                    inplace: bool = False) -> Callable:
    """One optimizer step ``(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm"})``.  ``microbatches`` > 1 accumulates
    the gradients in float32 over batch slices, then divides (the
    reference's scan); ``mixed_precision``: bfloat16 working params and the
    float32 master in the optimizer state.  ``inplace=True`` writes the new
    parameters and moments into the given tensors (the reference donates
    them to its jitted step)."""
    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch, cfg)
        else:
            slices = {k: v.chunk(microbatches, dim=0)
                      for k, v in batch.items()}
            loss, grads = None, None
            for i in range(microbatches):
                l, g = value_and_grad(
                    params, {k: v[i] for k, v in slices.items()}, cfg)
                g = [x.float() for x in g]
                if grads is None:       # the reference adds to zeros
                    loss, grads = l, g
                    continue
                loss = loss + l
                for acc, x in zip(grads, g):
                    acc.add_(x)
            loss = loss / microbatches
            for acc in grads:
                acc.div_(microbatches)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if mixed_precision:
            new_params, new_state, gnorm = adamw.update_mixed(
                opt_cfg, grads, opt_state, inplace=inplace)
        else:
            new_params, new_state, gnorm = adamw.update(
                opt_cfg, grads, opt_state, params, inplace=inplace)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch, caches):
        logits, caches = M.prefill(params, batch, caches, cfg)
        # serving prefill emits the first generated token
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1)
        return next_tok, caches
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def serve_step(params, tokens, caches, cache_len):
        logits, caches = M.decode_step(params, tokens, caches, cache_len,
                                       cfg)
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1)
        return next_tok, caches
    return serve_step


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Gradient-accumulation depth, the reference's rule: scale with model
    width x depth (activation bytes per token-layer) against its anchor
    (qwen3 at B=256, S=4k fits a 16 GB TPU chip at M=1)."""
    if shape.kind != "train":
        return 1
    cost = cfg.d_model * cfg.n_layers * shape.seq_len * shape.global_batch
    anchor = 2048 * 28 * 4096 * 256
    m = 1
    while cost > anchor * m and m < 64:
        m *= 2
    if cfg.n_experts:
        m *= 2
    while shape.global_batch % m:
        m //= 2
    return max(m, 1)


__all__ = ["TensorSpec", "input_specs", "cache_specs", "value_and_grad",
           "make_train_step", "make_prefill_step", "make_serve_step",
           "default_microbatches"]
