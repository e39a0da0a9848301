"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

24L d_model=1024 16H (GQA kv=8) d_ff=512 (expert width) vocab=49155.
"""
from repro_torch.configs.base import (FULL_ATTN_LONG_SKIP, ArchBundle,
                                      FLTopology, ModelConfig)

MODEL = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    num_experts=32,
    experts_per_token=8,
    tie_embeddings=True,
)

CONFIG = ArchBundle(
    model=MODEL,
    fl_single=FLTopology(clusters=8, devices_per_cluster=2),
    fl_multi=FLTopology(clusters=8, devices_per_cluster=4),
    skip_shapes=("long_500k",),
    skip_reason=FULL_ATTN_LONG_SKIP,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
