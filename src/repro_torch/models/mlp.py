"""Dense feed-forward layers (port of ``repro/models/mlp.py``): the plain
2-matmul MLP (gelu / squared-ReLU).  The gated form (GeGLU / SwiGLU) and
Mixture-of-Experts are not ported yet (ROADMAP queue A item 9)."""
from __future__ import annotations

import dataclasses

from .common import ParamSpec, activation, dense_spec


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "gelu"          # gelu | relu2 | silu | gelu_tanh
    use_bias: bool = False


def mlp_specs(cfg: MLPConfig) -> dict:
    E, F = cfg.d_model, cfg.d_ff
    specs = {"w_up": dense_spec(E, F), "w_down": dense_spec(F, E)}
    if cfg.use_bias:
        specs["b_up"] = ParamSpec((F,), init="zeros")
        specs["b_down"] = ParamSpec((E,), init="zeros")
    return specs


def mlp(p, x, cfg: MLPConfig):
    h = x @ p["w_up"]
    if cfg.use_bias:
        h = h + p["b_up"]
    out = activation(cfg.act)(h) @ p["w_down"]
    if cfg.use_bias:
        out = out + p["b_down"]
    return out
