"""xlstm-350m [ssm]: 24L d=1024 4H vocab=50304, alternating mLSTM + sLSTM
blocks (d_ff=0: projections live inside the blocks) [arXiv:2405.04517;
unverified], as in `repro.configs.xlstm_350m`.  Recurrent, so long_500k
runs."""

from ..models.transformer import ModelConfig
from .base import lm_input_specs

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab=50304, subquadratic=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="xlstm",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0, vocab=256,
    q_block=8, kv_block=8, loss_chunk=8, subquadratic=True,
)

SKIPS: dict = {}


def input_specs(shape: str, multi_pod: bool = False):
    return lm_input_specs(CONFIG, shape, multi_pod, SKIPS)
