"""llama4-scout-17b-a16e — MoE 16e top-1 every layer (~109B total / ~17B
active) [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attn=AttnConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                    rope_theta=500000.0),
    moe=MoEConfig(num_experts=16, top_k=1, num_shared=1, every=1),
    act="silu",
    skip_shapes=("long_500k",),
)
