"""Whisper-base [arXiv:2212.04356; unverified]: 6L enc + 6L dec, d512 8H
d_ff 2048, vocab 51865; conv frontend is a STUB -- input_specs feeds
precomputed log-mel frame embeddings (80-dim), projected linearly."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    is_encoder_decoder=True, n_enc_layers=6,
    frontend="audio", frontend_dim=80, frontend_tokens=0,
    rope_theta=1e4,
    tp=8,
)
