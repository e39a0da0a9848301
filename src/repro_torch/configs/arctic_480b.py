"""arctic-480b [moe] — 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (expert width) vocab=32000.
The dense-residual FFN runs in parallel with the MoE branch in each layer
(Arctic's dense-MoE hybrid), at the expert width 4864.  One replica is
about a terabyte: the port trains and serves it at smoke size only.
"""
from repro_torch.configs.base import (FULL_ATTN_LONG_SKIP, ArchBundle,
                                      FLTopology, HCEFConfig, ModelConfig)

MODEL = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_ff=4864,
    tie_embeddings=True,
    state_dtype="",  # plain SGD locally: momentum buffer does not fit
)

CONFIG = ArchBundle(
    model=MODEL,
    fl_single=FLTopology(clusters=1, devices_per_cluster=1, inner_dp=16),
    fl_multi=FLTopology(clusters=2, devices_per_cluster=1, inner_dp=16),
    skip_shapes=("long_500k",),
    skip_reason=FULL_ATTN_LONG_SKIP,
    hcef=HCEFConfig(momentum=0.0),
    source="hf:Snowflake/snowflake-arctic-base",
)
