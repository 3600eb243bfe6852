"""Decoder-only transformer LM, serving half (port of
``repro/models/transformer.py``): :func:`prefill` and :func:`decode_step`
for dense configs with every layer causal full attention
(``layer_pattern="global"``), plain GQA, untied or tied embeddings,
optional biases.  The JAX package scans stacked [L, …] parameters; the
port keeps ``params["blocks"]`` and the caches as lists of per-layer dicts
and loops over them.  :func:`params_from_reference` carries the JAX
package's parameters over.

Not ported yet, and raising: MoE layers, ``first_dense`` and the gated
MLP (ROADMAP queue A item 9); the gemma-2 extras — local/global
alternation, soft-capping, (1 + w) norms, post-block norms, embedding
scaling (queue A item 5).  The training half (``forward``, ``loss_fn``)
is item 9 too.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..index.base import resolve_device
from .attention import (AttentionConfig, attention, attn_specs,
                        decode_attention, init_cache)
from .common import ParamSpec, embed_lookup, norm_spec, rms_norm
from .mlp import MLPConfig, mlp, mlp_specs


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    act: str = "gelu"
    gated_mlp: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # normalization / gemma-2 extras
    norm_plus_one: bool = False      # (1 + w) RMSNorm weighting
    post_block_norm: bool = False    # norm after attn/mlp residual branch
    embed_scale: bool = False        # multiply embeddings by sqrt(d_model)
    attn_softcap: float | None = None
    final_softcap: float | None = None
    # attention pattern
    layer_pattern: str = "global"    # global | local_global
    window: int | None = None
    # MoE (n_experts == 0 ⇒ dense)
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert: bool = False
    d_ff_shared: int = 0             # 0 ⇒ same as d_ff_expert
    first_dense: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_cfg(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            rope_theta=self.rope_theta, use_bias=self.use_bias)

    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(self.d_model, self.d_ff, act=self.act,
                         use_bias=self.use_bias)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for a config the port cannot run yet (module docstring)."""
    if cfg.is_moe or cfg.first_dense or cfg.gated_mlp:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers and the gated MLP are not ported yet "
            f"(ROADMAP queue A item 9)")
    extras = [name for name, on in (
        ("layer_pattern=" + cfg.layer_pattern, cfg.layer_pattern != "global"),
        ("window", cfg.window is not None),
        ("attn_softcap", cfg.attn_softcap is not None),
        ("final_softcap", cfg.final_softcap is not None),
        ("norm_plus_one", cfg.norm_plus_one),
        ("post_block_norm", cfg.post_block_norm),
        ("embed_scale", cfg.embed_scale)) if on]
    if extras:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(extras)} not ported yet (ROADMAP queue "
            f"A item 5)")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: TransformerConfig) -> dict:
    d = cfg.d_model
    return {"attn": attn_specs(cfg.attn_cfg()), "ln_attn": norm_spec(d),
            "ln_mlp": norm_spec(d), "mlp": mlp_specs(cfg.mlp_cfg())}


def transformer_specs(cfg: TransformerConfig) -> dict:
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab
    specs: dict[str, Any] = {
        "embed": ParamSpec((V, d), init="embed"),
        "ln_final": norm_spec(d),
        "blocks": [_block_specs(cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, V))
    return specs


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy rejects: widening to
        # f32 and narrowing back is exact
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def params_from_reference(tree, *, device="cuda") -> dict:
    """The port's parameters from the JAX package's param tree (numpy or
    JAX arrays): the same leaves and dtypes, the stacked ``blocks``
    [L, …] unstacked into a list of per-layer dicts."""
    dev = resolve_device(device)
    if tree.get("dense0"):
        raise NotImplementedError("dense0 layers belong to MoE configs "
                                  "(ROADMAP queue A item 9)")

    def conv(t, i=None):
        if isinstance(t, dict):
            return {key: conv(val, i) for key, val in t.items()}
        return _tensor(t if i is None else np.asarray(t)[i], dev)

    out = {key: conv(val) for key, val in tree.items()
           if key not in ("blocks", "dense0")}
    n_layers = np.asarray(tree["blocks"]["ln_attn"]).shape[0]
    out["blocks"] = [conv(tree["blocks"], i) for i in range(n_layers)]
    return out


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _unembed(params, h, cfg: TransformerConfig):
    h = rms_norm(h, params["ln_final"])
    table = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ table


def prefill(params, tokens, positions, cfg: TransformerConfig,
            max_len: int | None = None):
    """Full-sequence forward that also materializes the KV caches.
    tokens, positions [B, S] -> (logits of the last position [B, V],
    caches: one {"k", "v"} [B, max_len, KH, Dh] per layer, in the
    activations' dtype, slots at or past S zero)."""
    check_supported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    acfg, mcfg = cfg.attn_cfg(), cfg.mlp_cfg()
    h = embed_lookup(params["embed"], tokens)
    caches = []
    for p in params["blocks"]:
        a, k, v = attention(p["attn"], rms_norm(h, p["ln_attn"]), positions,
                            acfg)
        cache = {}
        for name, t in (("k", k), ("v", v)):
            buf = t.new_zeros((B, max_len) + tuple(t.shape[2:]))
            buf[:, :S] = t
            cache[name] = buf
        caches.append(cache)
        h = h + a
        h = h + mlp(p["mlp"], rms_norm(h, p["ln_mlp"]), mcfg)
    return _unembed(params, h[:, -1:, :], cfg)[:, 0], caches


def decode_step(params, caches, token, position, cfg: TransformerConfig,
                *, backend: str | None = None):
    """One decode step.  token [B], position [B] -> (logits [B, V],
    caches), the caches updated in place at ``position``.  ``backend``
    picks decode attention's path (``ops.flash_decode``)."""
    check_supported(cfg)
    acfg, mcfg = cfg.attn_cfg(), cfg.mlp_cfg()
    h = embed_lookup(params["embed"], token[:, None])
    for p, cache in zip(params["blocks"], caches, strict=True):
        a, _ = decode_attention(p["attn"], rms_norm(h, p["ln_attn"]), cache,
                                position, acfg, backend=backend)
        h = h + a
        h = h + mlp(p["mlp"], rms_norm(h, p["ln_mlp"]), mcfg)
    return _unembed(params, h, cfg)[:, 0], caches


def init_caches(cfg: TransformerConfig, batch: int, max_len: int,
                device) -> list:
    """Zeroed decode caches: one {"k", "v"} [batch, max_len, KH, Dh]
    bf16 per layer."""
    check_supported(cfg)
    return [init_cache(cfg.attn_cfg(), batch, max_len, device)
            for _ in range(cfg.n_layers)]
