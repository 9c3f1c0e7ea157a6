"""Architecture configuration dataclasses + registry: a copy of
``repro.configs.base`` (which imports no JAX), so the port's model zoo reads
the same declarative configurations.

``pattern`` describes one repeating period of blocks (``num_layers /
len(pattern)`` periods), ``prefix`` holds non-repeating leading layers.
``reduced()`` is the CPU smoke-test variant of a family (one period,
d_model <= 256, <= 4 experts, tiny vocab, f32).  The package registers
every configuration of ``ASSIGNED`` (:func:`_load_all`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Block specs.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockSpec:
    """One sub-layer of a repeating period."""
    mixer: str = "attn"          # 'attn' | 'mamba' | 'rwkv'
    moe: bool = False            # MoE MLP instead of dense MLP


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0          # always-on shared experts (DeepSeek-MoE)
    d_ff_expert: Optional[int] = None   # fine-grained expert width
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"          # 'mamba' | 'rwkv6'
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # rwkv6 head size
    chunk: int = 64              # chunked-scan length (TPU-friendly)
    dt_rank: Optional[int] = None   # mamba Δ rank (default d_model/16)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (whisper). The modality frontend is
    a STUB: inputs are precomputed frame embeddings (see DESIGN.md)."""
    num_layers: int
    seq_len: int                 # e.g. 1500 mel frames after conv stub
    learned_pos: bool = True


@dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    citation: str
    # trunk ---------------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // num_heads
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    prefix: Tuple[BlockSpec, ...] = ()
    # features ------------------------------------------------------------
    mlp_type: str = "swiglu"     # swiglu | gelu | sqrelu
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0   # None = no RoPE
    learned_pos: bool = False               # learned absolute positions
    tie_embeddings: bool = False
    max_position: int = 1 << 20
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None      # None | 'audio' | 'vision' (STUB)
    frontend_tokens: int = 0            # stub embedding positions prepended
    sliding_window: Optional[int] = None  # beyond-paper long-ctx variant
    # numerics / distribution ----------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    sharding_policy: str = "node_dp"    # node_dp | node_fsdp
    n_nodes: int = 16                   # DL nodes on a single pod
    # ----------------------------------------------------------------------

    def __post_init__(self):
        unit = len(self.pattern)
        body = self.num_layers - len(self.prefix)
        if body % unit != 0:
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by "
                f"pattern of {unit}")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"{self.name}: heads not divisible by kv heads")

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.prefix)) // len(self.pattern)

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder is None

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included)."""
        d, V = self.d_model, self.vocab_size
        total = V * d                       # token embedding
        if not self.tie_embeddings:
            total += d * V                  # lm head
        if self.learned_pos:
            total += self.max_position_embed() * d
        def attn_params():
            qd = self.num_heads * self.head_dim
            kvd = self.num_kv_heads * self.head_dim
            p = d * qd + 2 * d * kvd + qd * d
            if self.qkv_bias:
                p += qd + 2 * kvd
            return p
        def mlp_params(moe: bool):
            mult = 2 if self.mlp_type == "swiglu" else 1
            if not moe or self.moe is None:
                return d * self.d_ff * mult + self.d_ff * d
            ff = self.moe.d_ff_expert or self.d_ff
            per = d * ff * mult + ff * d
            shared = self.moe.num_shared * per
            routed = self.moe.num_experts * per
            router = d * self.moe.num_experts
            return shared + routed + router
        def mamba_params():
            di = self.ssm.expand * d
            dt_rank = self.ssm.dt_rank or max(d // 16, 1)
            p = d * 2 * di                      # in_proj (x, z)
            p += di * self.ssm.d_conv           # depthwise conv
            p += di * (dt_rank + 2 * self.ssm.d_state)  # x -> dt,B,C
            p += dt_rank * di                   # dt_proj
            p += di * self.ssm.d_state + di     # A_log, D
            p += di * d                         # out_proj
            return p
        def rwkv_params():
            # r,k,v,g,w projections + output + ddlerp mus + decay lora + u
            p = 6 * d * d + 8 * d
            p += 2 * d * 64                     # decay LoRA (w1, w2)
            p += d                              # u bonus
            p += d * int(3.5 * d) + int(3.5 * d) * d   # channel-mix
            return p
        def block_params(spec: BlockSpec):
            p = 2 * d                           # two norms
            if spec.mixer == "attn":
                p += attn_params() + mlp_params(spec.moe)
            elif spec.mixer == "mamba":
                p += mamba_params() + mlp_params(spec.moe)
            elif spec.mixer == "rwkv":
                p += rwkv_params()
            return p
        for spec in self.prefix:
            total += block_params(spec)
        for spec in self.pattern:
            total += block_params(spec) * self.num_periods
        if self.encoder is not None:
            enc_block = 2 * d + attn_params() + mlp_params(False)
            total += self.encoder.num_layers * enc_block
            total += self.encoder.seq_len * d       # learned enc pos
            # decoder cross-attention adds another attn per layer
            total += self.num_layers * (attn_params() + d)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        mult = 2 if self.mlp_type == "swiglu" else 1
        ff = self.moe.d_ff_expert or self.d_ff
        per = d * ff * mult + ff * d
        n_moe_prefix = sum(1 for s in self.prefix if s.moe)
        n_moe_body = sum(1 for s in self.pattern if s.moe) * self.num_periods
        n_moe = n_moe_prefix + n_moe_body
        inactive = n_moe * (self.moe.num_experts - self.moe.top_k) * per
        return int(full - inactive)

    def max_position_embed(self) -> int:
        return min(self.max_position, 1 << 16)

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family: <=2 periods,
        d_model <= 256, <= 4 experts, tiny vocab."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=min(self.moe.num_experts, 4),
                          top_k=min(self.moe.top_k, 2),
                          num_shared=min(self.moe.num_shared, 1),
                          d_ff_expert=(min(self.moe.d_ff_expert, 128)
                                       if self.moe.d_ff_expert else None))
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, d_state=min(self.ssm.d_state, 8),
                          chunk=16)
        enc = None
        if self.encoder is not None:
            enc = replace(self.encoder, num_layers=2, seq_len=16)
        layers = len(self.prefix) + len(self.pattern)  # one period
        return replace(
            self, name=self.name + "-reduced",
            num_layers=layers, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=max(d // heads, 8),
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 512),
            moe=moe, ssm=ssm, encoder=enc,
            frontend_tokens=min(self.frontend_tokens, 4),
            param_dtype="float32", compute_dtype="float32",
            remat=False, n_nodes=4, max_position=1 << 14)


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import sibling modules lazily so `get_config` works standalone
        from . import _load_all
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
