"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H GQA(kv=16)
expert d_ff 1408, vocab 151936, 60 routed experts top-4 + 4 shared experts."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936,
    n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408, moe_period=1,
    rope_theta=1e6,
    tp=16, ep=16, etp=1,              # 60 -> 64 padded experts, 4 per shard
)
