"""Assigned architecture config (exact figures from the assignment table)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    source="arXiv:2407.10671; GQA kv=2, QKV bias",
))
