"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified], as in
`repro.configs.llava_next_34b`.

The vision tower is a stub, as in the JAX package: the batch supplies
precomputed patch embeddings (anyres: base 576 + 4 tiles x 576 = 2880
tokens) prepended to the text sequence; seq_len counts image + text
tokens.  Full attention, so long_500k is skipped."""

from ..models.transformer import ModelConfig
from .base import embeds_input_specs

NUM_IMAGE_TOKENS = 2880  # anyres: (1 base + 4 tiles) x 24x24 patches

CONFIG = ModelConfig(
    name="llava-next-34b", family="transformer",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, act="silu", rope_theta=5000000.0,
    num_image_tokens=NUM_IMAGE_TOKENS, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llava-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab=256, act="silu", num_image_tokens=8, tie_embeddings=False,
    q_block=8, kv_block=8, loss_chunk=8,
)

SKIPS = {"long_500k": "pure full attention (no sub-quadratic path)"}


def input_specs(shape: str, multi_pod: bool = False):
    return embeds_input_specs(CONFIG, shape, multi_pod, SKIPS,
                              num_image_tokens=NUM_IMAGE_TOKENS)
