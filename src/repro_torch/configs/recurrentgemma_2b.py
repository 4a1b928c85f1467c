"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1, hd=256) d_ff=7680
vocab=256000, RG-LRU + local attention at 1:2 ratio (rec, rec, attn)
[arXiv:2402.19427; hf], as in `repro.configs.recurrentgemma_2b`.
Recurrent + local attention (a 2048-slot window ring), so long_500k runs."""

from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="griffin",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, act="gelu", window=2048, d_rnn=2560,
    rope_theta=10000.0, embed_scale=True, subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="griffin",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=160, vocab=256, act="gelu", window=8, d_rnn=64, embed_scale=True,
    q_block=8, kv_block=8, loss_chunk=8, subquadratic=True,
)

SKIPS: dict = {}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
