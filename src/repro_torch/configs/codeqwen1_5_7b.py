"""codeqwen1.5-7b: qwen1.5 arch: QKV bias, MHA [hf:Qwen/CodeQwen1.5-7B; hf]

Exact assigned config (full) + reduced same-family smoke config.
"""

import dataclasses

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab=92416, head_dim=128, qkv_bias=True, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, attn_chunk=32, compute_dtype=torch.float32,
)
