"""Imports every bundled arch config so the registry is populated."""
from repro_torch.configs.internlm2_20b import CONFIG as internlm2_20b  # noqa: F401
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b  # noqa: F401
from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2_1_5b  # noqa: F401
from repro_torch.configs.minitron_8b import CONFIG as minitron_8b  # noqa: F401
from repro_torch.configs.falcon_mamba_7b import CONFIG as falcon_mamba_7b  # noqa: F401
from repro_torch.configs.deepseek_moe_16b import CONFIG as deepseek_moe_16b  # noqa: F401
from repro_torch.configs.qwen3_moe_30b import CONFIG as qwen3_moe_30b  # noqa: F401
from repro_torch.configs.chameleon_34b import CONFIG as chameleon_34b  # noqa: F401
from repro_torch.configs.seamless_m4t_medium import CONFIG as seamless_m4t_medium  # noqa: F401
from repro_torch.configs.hymba_1_5b import CONFIG as hymba_1_5b  # noqa: F401

ALL = [internlm2_20b, granite_3_2b, qwen2_1_5b, minitron_8b, falcon_mamba_7b, deepseek_moe_16b, qwen3_moe_30b, chameleon_34b, seamless_m4t_medium, hymba_1_5b]
