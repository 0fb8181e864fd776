"""mamba2-130m: SSD (state-space duality) [arXiv:2405.21060; unverified]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_chunk=64, conv_width=4, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, vocab=512, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, compute_dtype=torch.float32,
)
