"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA kv=32). [hf:Qwen/CodeQwen1.5-7B; hf]

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import (FULL_ATTN_LONG_SKIP, ArchBundle,
                                      FLTopology, ModelConfig)

MODEL = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13_440,
    vocab_size=92_416,
    qkv_bias=True,
    tie_embeddings=False,
)

CONFIG = ArchBundle(
    model=MODEL,
    fl_single=FLTopology(clusters=8, devices_per_cluster=2),
    fl_multi=FLTopology(clusters=8, devices_per_cluster=4),
    skip_shapes=("long_500k",),
    skip_reason=FULL_ATTN_LONG_SKIP,
    source="hf:Qwen/CodeQwen1.5-7B",
)
