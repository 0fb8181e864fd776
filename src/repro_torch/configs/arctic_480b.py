"""arctic-480b: 128 experts top-2 + dense residual MLP [hf:Snowflake/snowflake-arctic-base; hf]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128, n_experts=128, moe_top_k=2,
    dense_residual=True, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512, n_experts=4, moe_group_size=64, attn_chunk=32,
    compute_dtype=torch.float32,
)
