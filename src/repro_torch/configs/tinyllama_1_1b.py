"""tinyllama-1.1b [dense]: 22L d=2048 32H (GQA kv=4) d_ff=5632 vocab=32000,
Llama2-arch small [arXiv:2401.02385], as in `repro.configs.tinyllama_1_1b`.
Full attention, so the long_500k cell is skipped."""

from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="transformer",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=5632, vocab=32000, act="silu", rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab=256, act="silu", tie_embeddings=False,
    q_block=8, kv_block=8, loss_chunk=8,
)

SKIPS = {"long_500k": "pure full attention (no sub-quadratic path)"}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
