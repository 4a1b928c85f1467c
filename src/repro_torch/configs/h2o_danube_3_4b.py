"""h2o-danube-3-4b [dense]: 24L d=3840 32H (GQA kv=8) d_ff=10240 vocab=32000,
Llama and Mistral mix with sliding-window attention [arXiv:2401.16818], as
in `repro.configs.h2o_danube_3_4b`.  The window (4096) makes the decode
cache a 4096-slot ring, linear in context, so the long_500k cell runs."""

from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="transformer",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8, head_dim=120,
    d_ff=10240, vocab=32000, act="silu", window=4096, rope_theta=10000.0,
    tie_embeddings=False, subquadratic=True,
)

SMOKE = ModelConfig(
    name="danube-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab=256, act="silu", window=8, tie_embeddings=False,
    q_block=8, kv_block=8, loss_chunk=8, subquadratic=True,
)

SKIPS: dict = {}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
