"""smollm-135m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import (FULL_ATTN_LONG_SKIP, ArchBundle,
                                      FLTopology, ModelConfig)

MODEL = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49_152,
    tie_embeddings=True,
)

CONFIG = ArchBundle(
    model=MODEL,
    fl_single=FLTopology(clusters=8, devices_per_cluster=2),
    fl_multi=FLTopology(clusters=8, devices_per_cluster=4),
    skip_shapes=("long_500k",),
    skip_reason=FULL_ATTN_LONG_SKIP,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
