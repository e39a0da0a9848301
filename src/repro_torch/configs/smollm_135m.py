"""smollm-135m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ArchBundle, ModelConfig

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

CONFIG = ArchBundle(model=MODEL, source="hf:HuggingFaceTB/SmolLM-135M")
