"""PaliGemma 3B [arXiv:2407.07726]: SigLIP vision tower STUBBED —
input_specs() provides 256 patch embeddings; gemma backbone, MQA kv=1."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257_216,
    n_patches=256, act="gelu",
)
