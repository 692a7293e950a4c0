"""gemma2-27b — local(4096)/global alternating attention, logit softcaps,
GeGLU, sandwich norms [arXiv:2408.00118]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab_size=256000,
    attn=AttnConfig(num_heads=32, num_kv_heads=16, head_dim=128,
                    logit_softcap=50.0, sliding_window=4096,
                    local_global_pattern=2),
    final_logit_softcap=30.0,
    post_norms=True,
    act="geglu",
    # long_500k RUNS: half the layers are sliding-window (rolling 4096
    # cache); global layers keep full KV sharded over 'model' (DESIGN §6).
    skip_shapes=(),
)
