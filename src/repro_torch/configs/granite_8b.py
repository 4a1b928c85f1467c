"""granite-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152,
Llama-arch code model [arXiv:2405.04324], as in `repro.configs.granite_8b`.
Full attention, so the long_500k cell is skipped."""

from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="granite-8b", family="transformer",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=49152, act="silu", rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="transformer",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab=256, act="silu", tie_embeddings=False,
    q_block=8, kv_block=8, loss_chunk=8,
)

SKIPS = {"long_500k": "pure full attention (no sub-quadratic path)"}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
