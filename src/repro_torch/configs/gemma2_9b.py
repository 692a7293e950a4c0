"""gemma2-9b — local/global alternating, softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                    logit_softcap=50.0, sliding_window=4096,
                    local_global_pattern=2),
    final_logit_softcap=30.0,
    post_norms=True,
    act="geglu",
    skip_shapes=(),
)
