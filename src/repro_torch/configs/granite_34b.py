"""Granite 34B code [arXiv:2405.04324]: llama-arch, MQA (kv=1), 88 layers."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49_152,
    act="gelu", tie_embeddings=True, gated_mlp=False,  # GPTBigCode-style MLP
)
