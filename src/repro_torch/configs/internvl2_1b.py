"""internvl2-1b — InternViT patch STUB + Qwen2-0.5B-like LM backbone
[arXiv:2404.16821]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151655,
    attn=AttnConfig(num_heads=14, num_kv_heads=2, head_dim=64,
                    rope_theta=1000000.0),
    act="silu",
    skip_shapes=("long_500k",),
)
