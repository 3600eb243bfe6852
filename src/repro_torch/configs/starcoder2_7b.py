"""StarCoder2-7B — dense GQA code LM [arXiv:2402.19173; hf].

32L, d_model 4608, 36 heads (GQA kv=4, head_dim 128), d_ff 18432 (plain
GELU MLP with biases), vocab 49152, RoPE (theta 1e5), untied embeddings.
"""
from ..arch import ArchSpec
from ..models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="starcoder2_7b",
    family="transformer",
    cfg=TransformerConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
        n_kv_heads=4, head_dim=128, d_ff=18432, vocab=49152,
        act="gelu_tanh", gated_mlp=False, use_bias=True,
        rope_theta=1e5, tie_embeddings=False),
)
