"""Gemma3-1B [hf:google/gemma-3-1b-pt; unverified]: 26L d1152 4H GQA(kv=1)
d_ff 6912, vocab 262144, 5:1 local:global attention (local window 512)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    local_global_ratio=5, local_window=512, rope_theta=1e6,
    tie_embeddings=True,
    tp=4,                              # 4 q heads bound the head parallelism
    subquadratic=True,                 # local layers bounded; global layers
                                       # decode via seq-sharded flash-decode
)
