"""LLaVA-NeXT-34B backbone [hf:llava-hf/llava-v1.6-*; unverified]: 60L d7168
56H GQA(kv=8) d_ff 20480, vocab 64000; anyres patch frontend is a STUB --
input_specs feeds precomputed patch embeddings (CLIP-L hidden 1024)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    rope_theta=5e6,
    frontend="patch", frontend_tokens=2880, frontend_dim=1024,
    tp=8,                              # 56 heads: 7 per shard
)
