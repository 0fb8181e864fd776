"""qwen2-vl-72b: M-RoPE, dynamic-resolution vision stub [arXiv:2409.12191; hf]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, mrope_sections=(16, 24, 24),
    frontend="vision", rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, mrope_sections=(2, 3, 3), attn_chunk=32,
    compute_dtype=torch.float32,
)
