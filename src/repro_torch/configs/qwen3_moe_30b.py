"""Assigned architecture config (exact figures from the assignment table)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936,
    head_dim=128,  # hf:Qwen/Qwen3-30B-A3B uses head_dim=128 (!= d_model/n_heads)
    moe=MoEConfig(n_experts=128, n_shared_experts=0, top_k=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B; 128 experts top-8",
))
