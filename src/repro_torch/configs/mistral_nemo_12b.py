"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407]: llama-arch,
explicit head_dim 128, 128k context, vocab 131072 (tekken)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131_072,
    rope_theta=1_000_000.0, tie_embeddings=False,
)
