"""The paper's own evaluation vehicle: a small dense LM we can train from
scratch on CPU, calibrate, and PTQ with every transform (benchmarks/)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="catlm-60m", family="dense",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
    d_ff=1536, vocab=8192,
    cat_block=64,
)
