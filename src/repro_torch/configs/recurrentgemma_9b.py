"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2.
[arXiv:2402.19427; unverified]

38L d_model=4096 16H (GQA kv=1/MQA) d_ff=12288 vocab=256000.  Block pattern is
(rglru, rglru, attn) repeating (Griffin 1 attention per 2 recurrent); 38 = 12*3
+ 2 trailing recurrent blocks.  Local attention window 2048 => sub-quadratic.
"""
from repro_torch.configs.base import ArchBundle, ModelConfig

MODEL = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    window=2048,
    lru_width=4096,
    tie_embeddings=True,
    logits_softcap=30.0,
)

CONFIG = ArchBundle(model=MODEL, source="arXiv:2402.19427")
