"""mamba2-1.3b [ssm] — SSD (state-space duality). [arXiv:2405.21060]

48L d_model=2048 (attention-free) d_ff=0 vocab=50280, ssm_state=128
(own copy of ``repro/configs/mamba2_1p3b.py``).
"""
from repro_torch.configs.base import ArchBundle, FLTopology, ModelConfig

MODEL = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=8,
    expand=2,
    conv_width=4,
    tie_embeddings=True,
)

CONFIG = ArchBundle(
    model=MODEL,
    fl_single=FLTopology(clusters=8, devices_per_cluster=2),
    fl_multi=FLTopology(clusters=8, devices_per_cluster=4),
    source="arXiv:2405.21060",
)
