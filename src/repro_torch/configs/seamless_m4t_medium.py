"""Assigned architecture config (exact figures from the assignment table)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, enc_dec=True,
    frontend="audio_frames",
    source="arXiv:2308.11596; enc-dec, multimodal",
))
