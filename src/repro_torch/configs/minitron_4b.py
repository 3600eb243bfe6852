"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679; hf].

32L, d_model 3072, 24 heads (GQA kv=8, head_dim 128), d_ff 9216 with
squared-ReLU, vocab 256000, untied.
"""
from ..arch import ArchSpec
from ..models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="minitron_4b",
    family="transformer",
    cfg=TransformerConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=9216, vocab=256000,
        act="relu2", gated_mlp=False, rope_theta=1e4,
        tie_embeddings=False),
)
