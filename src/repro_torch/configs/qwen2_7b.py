"""qwen2-7b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ArchBundle, ModelConfig

MODEL = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    tie_embeddings=False,
)

CONFIG = ArchBundle(model=MODEL, source="arXiv:2407.10671")
