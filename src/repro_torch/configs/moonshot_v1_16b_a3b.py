"""Moonlight 16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 64 experts top-6,
per-expert d_ff 1408, vocab 163840."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163_840,
    n_experts=64, top_k=6, tie_embeddings=False,
)
