"""Assigned architecture config (exact figures from the assignment table)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base; GQA kv=8",
))
