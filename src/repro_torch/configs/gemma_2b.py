"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, embeddings scaled by sqrt(d), tied head
[arXiv:2403.08295], as in `repro.configs.gemma_2b`.  Full attention, so
the long_500k cell is skipped."""

from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="gemma-2b", family="transformer",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="gelu", embed_scale=True,
    rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=256, vocab=512, act="gelu", embed_scale=True, tie_embeddings=True,
    q_block=8, kv_block=8, loss_chunk=8,
)

SKIPS = {"long_500k": "pure full attention (no sub-quadratic path)"}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
