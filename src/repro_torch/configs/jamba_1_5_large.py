"""Jamba-1.5-Large 398B [arXiv:2403.19887]: 72L d8192, Mamba:attention 7:1
interleave (one attention layer per 8), 64H GQA(kv=8), MoE every 2nd layer
(16 experts top-2, expert d_ff 24576), vocab 65536."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    mixer_pattern="mmmmAmmm",          # attention at position 5 of each 8
    n_experts=16, top_k=2, d_ff_expert=24576, moe_period=2,
    d_state=16, mamba_expand=2, conv_kernel=4,
    rope_theta=1e6,
    tp=16, ep=16, etp=1,
    subquadratic=True,                 # mamba state O(1); 9 attn layers
                                       # decode via seq-sharded flash-decode
)
