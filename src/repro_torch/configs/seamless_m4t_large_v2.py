"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal. [arXiv:2308.11596; hf]

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  Backbone only: the
audio frontend is a stub; precomputed frame embeddings
(``batch["frames"]``, (B, S_enc, d_model)) feed the 24-layer encoder
(non-causal self-attention).  The decoder uses causal self-attention,
then cross-attention over the encoder's output.
"""
from repro_torch.configs.base import ArchBundle, ModelConfig

MODEL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,  # decoder layers
    enc_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio_stub",
    tie_embeddings=False,
)

CONFIG = ArchBundle(model=MODEL, source="arXiv:2308.11596")
