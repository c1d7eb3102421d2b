"""Assigned architecture config (exact figures from the assignment table)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408),
    source="arXiv:2401.06066; 2 shared + 64 routed top-6, fine-grained",
))
