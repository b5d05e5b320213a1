"""Gemma 2 2B [arXiv:2408.00118]: local+global alternating attention (1:1,
window 4096), logit softcapping, sandwich norms, head_dim 256."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256_000,
    window=4096, local_ratio=1,          # alternating local:global
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
    act="gelu", tie_embeddings=True,
)
