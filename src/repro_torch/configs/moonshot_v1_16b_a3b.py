"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) d_ff(expert)=1408
vocab=163840, MoE 64 routed top-6 [hf:moonshotai/Moonlight-16B-A3B], as in
`repro.configs.moonshot_v1_16b_a3b` (64 experts top-6 and no shared
experts, as the JAX package has it; the HF release adds 2 shared).  Full
attention, so the long_500k cell is skipped."""

from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="transformer",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840, act="silu",
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=0),
    rope_theta=10000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=64, vocab=256, act="silu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared=0),
    tie_embeddings=False, q_block=8, kv_block=8, loss_chunk=8,
)

SKIPS = {"long_500k": "pure full attention (no sub-quadratic path)"}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
