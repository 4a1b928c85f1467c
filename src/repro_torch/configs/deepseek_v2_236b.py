"""deepseek-v2-236b [moe]: 60L d=5120 128H d_ff(expert)=1536 vocab=102400,
MoE 160 routed top-6 + 2 shared, MLA kv_lora=512 [arXiv:2405.04434], as in
`repro.configs.deepseek_v2_236b`: all 60 layers MoE (the HF release keeps
layer 0 dense), MLA with q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64,
v_head 128.  Full attention, so the long_500k cell is skipped."""

from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="transformer",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=1536, vocab=102400, act="silu",
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2),
    mla={"q_lora": 1536, "kv_lora": 512, "rope_head_dim": 64, "v_head_dim": 128},
    rope_theta=10000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=64, vocab=256, act="silu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared=1),
    mla={"q_lora": 48, "kv_lora": 32, "rope_head_dim": 8, "v_head_dim": 16},
    tie_embeddings=False, q_block=8, kv_block=8, loss_chunk=8,
)

SKIPS = {"long_500k": "pure full attention (no sub-quadratic path)"}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
