"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    d_ff=8192,
    vocab_size=49155,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=64),
    act="silu",
    skip_shapes=("long_500k",),
)
