"""zamba2-7b — Mamba2 backbone + ONE shared attention block applied every
6 blocks (weights shared across sites) [arXiv:2411.15242]."""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=112),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    act="gelu",
    skip_shapes=(),           # hybrid: SSM state + one shared-KV family
)
