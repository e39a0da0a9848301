"""internvl2-2b [vlm] — InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The ViT frontend is a
stub: the first ``frontend_tokens`` positions take precomputed patch
embeddings (``batch["patch_embeds"]``, (B, 256, d_model)) in place of the
token embeddings, and the loss leaves their labels out.
"""
from repro_torch.configs.base import (FULL_ATTN_LONG_SKIP, ArchBundle,
                                      FLTopology, ModelConfig)

MODEL = ModelConfig(
    name="internvl2-2b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    frontend="vit_stub",
    frontend_tokens=256,
    tie_embeddings=False,
)

CONFIG = ArchBundle(
    model=MODEL,
    fl_single=FLTopology(clusters=8, devices_per_cluster=2),
    fl_multi=FLTopology(clusters=8, devices_per_cluster=4),
    skip_shapes=("long_500k",),
    skip_reason=FULL_ATTN_LONG_SKIP,
    source="arXiv:2404.16821",
)
