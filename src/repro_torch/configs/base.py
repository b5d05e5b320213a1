"""Architecture config schema + registry.

One module per assigned architecture lives next to this file; each exports
``CONFIG`` (the exact published shape) and the registry maps ``--arch`` ids
to them. ``ArchConfig.scaled()`` derives reduced smoke-test variants.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention pattern
    window: Optional[int] = None    # sliding-window size for local layers
    local_ratio: int = 0            # N local layers per 1 global (0 = all global)
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    qk_norm: bool = False
    post_norms: bool = False        # gemma2/3 sandwich norms
    rope_theta: float = 10_000.0
    act: str = "silu"               # silu | gelu

    gated_mlp: bool = True          # False: plain up/act/down (GPTBigCode)

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    attn_every: int = 0             # zamba2: shared attn block every N layers

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                # precomputed frame embeddings (stub frontend)

    # vlm (paligemma)
    n_patches: int = 0              # precomputed patch embeddings (stub tower)

    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # CAT / quantization defaults for this arch
    cat_block: int = 128
    kv_quant_bits: int = 0          # >0: dynamic per-token KV cache quant

    # distribution / memory knobs (the §Perf iteration space)
    remat: bool = False             # checkpoint the layer-scan body
    act_shard: str = "none"         # none | seq (Megatron-SP carry)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does not grow with context (SSM/linear-attn
        dominated) — gates the long_500k shape (see DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=32,
            d_ff=256,
            vocab=512,
        )
        if self.n_experts:
            # capacity_factor E/k guarantees dropless routing => the
            # prefill/decode == teacher-forced consistency contract is exact.
            small.update(n_experts=4, top_k=2, d_ff=64, capacity_factor=2.0)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_heads=4)
        if self.attn_every:
            small.update(n_layers=4, attn_every=2)
        if self.n_enc_layers:
            small.update(n_enc_layers=2, enc_seq=16)
        if self.n_patches:
            small.update(n_patches=8)
        if self.window:
            small.update(window=16)
        return dataclasses.replace(self, **small)


# The port carries the configurations its slices serve; the JAX package's
# registry (repro.configs.base.ARCH_IDS) lists every assigned architecture.
ARCH_IDS = [
    # the paper's own evaluation model (a small LM used by benchmarks)
    "catlm_60m",
    # the dense and vlm families of the reference's registry
    "gemma2_2b",
    "mistral_nemo_12b",
    "granite_34b",
    "gemma3_12b",
    "paligemma_3b",
    # the moe family
    "granite_moe_1b_a400m",
    "moonshot_v1_16b_a3b",
]


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_")
    assert arch in ARCH_IDS, f"unknown arch {arch!r}; known: {ARCH_IDS}"
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
