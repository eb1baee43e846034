"""RWKV6 (Finch) 7B [arXiv:2404.05892]: 32L d4096 attention-free
(data-dependent decay linear attention), channel-mix d_ff 14336,
vocab 65536."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=14336, vocab_size=65536,
    mixer_pattern="r", rwkv_head_dim=64,
    tp=16, serve_tp=64,
    subquadratic=True,
)
