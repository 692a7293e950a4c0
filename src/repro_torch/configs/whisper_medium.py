"""whisper-medium — enc-dec audio backbone, conv frontend STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,            # encoder layers
    num_decoder_layers=24,    # decoder layers (whisper-medium is 24+24)
    d_model=1024,
    d_ff=4096,
    vocab_size=51865,
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=64),
    act="gelu",
    skip_shapes=("long_500k",),  # full-attention enc-dec
)
