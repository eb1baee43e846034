"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L d4096 32H GQA(kv=8) per-expert
d_ff 14336, vocab 32000, 8 experts top-2, sliding-window attention 4096."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, d_ff_expert=14336, moe_period=1,
    window=4096,                      # SWA: bounded KV => long-context capable
    rope_theta=1e6,
    tp=16, ep=8, etp=2,               # model axis 16 = 8 experts x 2-way etp
    subquadratic=True,
)
