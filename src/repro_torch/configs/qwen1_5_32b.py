"""qwen1.5-32b: QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, attn_chunk=32, compute_dtype=torch.float32,
)
