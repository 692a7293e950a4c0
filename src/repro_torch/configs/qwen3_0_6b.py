"""qwen3-0.6b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    d_ff=3072,
    vocab_size=151936,
    attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=128,
                    qk_norm=True, rope_theta=1000000.0),
    act="silu",
    skip_shapes=("long_500k",),   # pure full attention
)
