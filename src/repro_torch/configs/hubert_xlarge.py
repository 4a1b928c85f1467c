"""hubert-xlarge [audio]: 48L d=1280 16H d_ff=5120 vocab=504, encoder-only
(the wav2vec2 architecture), as in `repro.configs.hubert_xlarge`.

The modality frontend (the CNN feature extractor) is a stub, as in the JAX
package: the batch supplies precomputed frame embeddings (B, S, 1280).
Plain GELU MLP (not gated), no rope (the frontend handles position).  The
head is padded from 504 to 512 classes (8 dead classes, cut off before the
log-softmax).  Encoder-only, so the decode cells are skipped.

This is the paper-primary arch: its emissions feed the FLASH-BS forced-
alignment step (`serving.alignment.make_e2e_align_step`), the paper's TIMIT
workload.
"""

from ..models.transformer import ModelConfig
from .base import embeds_input_specs

NUM_CLASSES = 504  # true classes; head padded to 512

CONFIG = ModelConfig(
    name="hubert-xlarge", family="transformer",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=512, act="gelu", encoder_only=True, embed_inputs=False,
    mlp_glu=False, use_rope=False, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab=32, act="gelu", encoder_only=True, embed_inputs=False,
    mlp_glu=False, use_rope=False, tie_embeddings=False,
    q_block=8, kv_block=8, loss_chunk=8,
)

SKIPS = {
    "decode_32k": "encoder-only: no autoregressive decode step",
    "long_500k": "encoder-only: no autoregressive decode step",
}


def input_specs(shape: str, multi_pod: bool = False):
    return embeds_input_specs(CONFIG, shape, multi_pod, SKIPS)
