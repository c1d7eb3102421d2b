"""Architecture & shape configuration system.

Every assigned architecture is expressed as an ``ArchConfig``; every assigned
input shape as a ``ShapeConfig``.  The registry maps ``--arch <id>`` to a
config, mirroring how V-BOINC lets a volunteer select any BOINC project: the
capsule runtime is identical, only the payload (arch) changes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0     # always-on shared experts (DeepSeekMoE)
    top_k: int = 0
    d_ff_expert: int = 0          # per-expert hidden size
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> d_model // 16


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    enc_dec: bool = False         # seamless: n_layers encoder + n_layers decoder
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None        # None | "vq_image" | "audio_frames"
    # sliding-window attention (beyond-paper extra enabling long ctx on dense)
    window: int = 0                        # 0 -> full attention
    source: str = ""                       # provenance note

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm.dt_rank or max(1, self.d_model // 16)

    def padded_vocab(self, multiple: int = 128) -> int:
        """Vocab padded for MXU alignment + mesh divisibility (DESIGN.md §4)."""
        return _round_up(self.vocab_size, multiple)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        v = self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family != "ssm":
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * hd
            per_layer += attn
        if self.family in ("ssm", "hybrid"):
            di, st = self.d_inner, self.ssm.d_state
            per_layer += d * 2 * di + di * self.ssm.d_conv \
                + di * (self.dt_rank + 2 * st) + self.dt_rank * di \
                + di * st + di + di * d
        if self.is_moe:
            fe = self.moe.d_ff_expert
            routed = self.moe.n_experts * 3 * d * fe
            shared = self.moe.n_shared_experts * 3 * d * fe
            per_layer += routed + shared + d * self.moe.n_experts
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        n_layers = self.n_layers * (2 if self.enc_dec else 1)
        if self.enc_dec:  # decoder cross-attention
            per_layer_dec_extra = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            return emb + n_layers * per_layer + self.n_layers * per_layer_dec_extra
        return emb + n_layers * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        fe = self.moe.d_ff_expert
        inactive = (self.moe.n_experts - self.moe.top_k) * 3 * d * fe
        return self.param_count() - self.n_layers * inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Cell disposition per DESIGN.md §4 (documented skips)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("long_500k skipped: pure full-attention arch "
                       "(O(L^2)); see DESIGN.md §4")
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import side-effect registration of all bundled configs
    from repro_torch.configs import all_configs  # noqa: F401


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            n_heads: int = 4, n_kv_heads: int = 0, d_ff: int = 128,
            vocab_size: int = 256) -> ArchConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    kv = n_kv_heads or max(1, n_heads // 2)
    kw = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=min(kv, n_heads), d_ff=d_ff, vocab_size=vocab_size,
        head_dim=d_model // n_heads,
    )
    if cfg.is_moe:
        kw["moe"] = MoEConfig(n_experts=4, n_shared_experts=cfg.moe.n_shared_experts and 1,
                              top_k=2, d_ff_expert=32)
        kw["d_ff"] = 0
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = SSMConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
