"""Gemma 3 12B [hf:google/gemma-3 family]: 5:1 local:global (window 1024),
qk-norm instead of attn softcap, 128k context, vocab 262144."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262_144,
    window=1024, local_ratio=5, qk_norm=True, post_norms=True,
    logit_softcap=0.0, act="gelu", rope_theta=1_000_000.0,
)
