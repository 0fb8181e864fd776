"""mixtral-8x7b: 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, n_experts=8, moe_top_k=2, window=4096,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512, n_experts=4, moe_group_size=64, window=32,
    attn_chunk=32, compute_dtype=torch.float32,
)
