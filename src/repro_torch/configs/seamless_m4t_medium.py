"""seamless-m4t-medium: enc-dec, audio frontend stub [arXiv:2308.11596; hf]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, frontend="audio",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, attn_chunk=32, compute_dtype=torch.float32,
)
