"""recurrentgemma-2b: RG-LRU + local attention, 1 attn : 2 rec [arXiv:2402.19427; hf]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid_rglru",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, lru_width=2560, conv_width=4,
    block_pattern=("rec", "rec", "attn_local"), window=2048,
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, lru_width=64, window=32, attn_chunk=32,
    compute_dtype=torch.float32,
)
