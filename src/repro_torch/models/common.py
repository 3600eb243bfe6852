"""Model-building primitives (port of ``repro/models/common.py``).

Spec-first parameters, as in the JAX package: each module describes its
parameters as a tree (dicts and lists) of :class:`ParamSpec` (shape and
initializer), and :func:`init_params` materializes one.  Parameters
are bf16; norms, RoPE and softmax compute in f32.

Two numerics traps of the translation, pinned by ``tests/test_torch_
decode.py``: ``jax.nn.gelu`` is the tanh approximation by default, while
``torch.nn.functional.gelu`` is exact unless ``approximate="tanh"``; and
RoPE keeps the JAX package's half-split layout and its
``exp(-log θ · i/half)`` frequencies.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

PARAM_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"       # normal | zeros | ones | embed

    @property
    def std(self) -> float:
        """The normal initializer's standard deviation: 1/√fan-in, the
        fan-in being every axis but the last (1/√d for an embedding)."""
        if self.init == "embed":
            return 1.0 / math.sqrt(self.shape[-1])
        return 1.0 / math.sqrt(max(1, math.prod(self.shape[:-1])))


def spec_leaves(tree):
    """The ParamSpec leaves of a tree, dict keys in sorted order (the
    JAX package's flattening order) and lists in order."""
    if isinstance(tree, ParamSpec):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from spec_leaves(tree[key])
    else:
        for item in tree:
            yield from spec_leaves(item)


def map_specs(fn, tree):
    """``tree`` with every ParamSpec leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {key: map_specs(fn, tree[key]) for key in sorted(tree)}
    return [map_specs(fn, item) for item in tree]


def init_params(generator: torch.Generator, spec_tree, *,
                dtype=PARAM_DTYPE):
    """Materialize a ParamSpec tree on the generator's device: zeros,
    ones, or a normal draw in f32 scaled by the spec's std and cast to
    ``dtype``.  The draws differ from ``jax.random``'s; parity tests carry
    the JAX package's parameters over instead
    (``transformer.params_from_reference``)."""
    dev = generator.device

    def one(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        x = torch.randn(spec.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(spec.std).to(dtype)
    return map_specs(one, spec_tree)


def count_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(spec_tree))


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _relu2(x):
    return torch.square(F.relu(x))


def activation(name: str):
    """The activation of the JAX package's name.  ``"gelu"`` is
    ``jax.nn.gelu``'s default, the tanh approximation."""
    if name in ("gelu", "gelu_tanh"):
        return _gelu_tanh
    if name == "relu2":          # Nemotron squared-ReLU
        return _relu2
    if name == "silu":
        return F.silu
    raise ValueError(f"unknown activation {name!r}")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> [B, S, d] rows of ``table``."""
    return F.embedding(tokens.long(), table)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE.  x [B, S, H, D]; positions [B, S] int: the half-split
    layout (the first and second halves of D rotate as pairs), in f32."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freq       # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# spec helpers for frequently used layers
# ---------------------------------------------------------------------------

def dense_spec(d_in: int, d_out: int) -> ParamSpec:
    """[d_in, d_out] matmul weight (one layer's: the port keeps layers in
    a list, where the JAX package stacks them)."""
    return ParamSpec((d_in, d_out))


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), init="ones")
