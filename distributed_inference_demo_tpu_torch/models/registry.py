"""Model catalog: every family the reference supports plus BASELINE targets.

A copy of ``distributed_inference_demo_tpu/models/registry.py`` (the port
keeps its own, since importing the JAX package's ``models`` pulls JAX in).
``-int8`` / ``-int4`` names resolve to a config as there.

Also provides tiny "-test" configs for fast unit tests.
"""

from .base import ModelConfig


def _bloom(hidden, layers, heads, vocab=250880) -> ModelConfig:
    return ModelConfig(
        family="bloom", vocab_size=vocab, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=heads, intermediate_size=4 * hidden,
        max_seq_len=2048, use_alibi=True, use_rope=False, attn_layernorm=True,
        tie_embeddings=True, norm_eps=1e-5)


MODEL_REGISTRY = {
    # --- bloom family (reference parity: data/Data.kt:19-33) ---
    "bloom560m": _bloom(1024, 24, 16),
    "bloom1b1": _bloom(1536, 24, 16),
    "bloom1b7": _bloom(2048, 24, 16),
    "bloom3b": _bloom(2560, 30, 32),
    "bloom7b1": _bloom(4096, 30, 32),
    # --- llama family (BASELINE.json configs 1-3) ---
    "tinyllama-1.1b": ModelConfig(
        family="llama", vocab_size=32000, hidden_size=2048, num_layers=22,
        num_heads=32, num_kv_heads=4, intermediate_size=5632,
        max_seq_len=2048, rope_theta=10000.0),
    "llama-3-8b": ModelConfig(
        family="llama", vocab_size=128256, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, intermediate_size=14336,
        max_seq_len=8192, rope_theta=500000.0),
    # --- qwen2 family (llama block + qkv biases; beyond-reference
    # breadth: the catalog pattern extends to new HF families without a
    # new decoder) ---
    "qwen2.5-7b": ModelConfig(
        family="qwen2", vocab_size=152064, hidden_size=3584, num_layers=28,
        num_heads=28, num_kv_heads=4, intermediate_size=18944,
        max_seq_len=32768, rope_theta=1000000.0, norm_eps=1e-6,
        attn_qkv_bias=True),
    "qwen2.5-0.5b": ModelConfig(
        family="qwen2", vocab_size=151936, hidden_size=896, num_layers=24,
        num_heads=14, num_kv_heads=2, intermediate_size=4864,
        max_seq_len=32768, rope_theta=1000000.0, norm_eps=1e-6,
        attn_qkv_bias=True, tie_embeddings=True),
    # --- gemma family (RMSNorm(1+w) folded at load, sqrt(H) embedding
    # scale, GeGLU, decoupled head_dim; gemma-2b is MQA) ---
    "gemma-7b": ModelConfig(
        family="gemma", vocab_size=256000, hidden_size=3072, num_layers=28,
        num_heads=16, num_kv_heads=16, intermediate_size=24576,
        max_seq_len=8192, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True, head_dim_override=256, embed_scale=True,
        mlp_act="gelu_tanh"),
    "gemma-2b": ModelConfig(
        family="gemma", vocab_size=256000, hidden_size=2048, num_layers=18,
        num_heads=8, num_kv_heads=1, intermediate_size=16384,
        max_seq_len=8192, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True, head_dim_override=256, embed_scale=True,
        mlp_act="gelu_tanh"),
    # --- mixtral MoE (BASELINE.json config 4) ---
    "mixtral-8x7b": ModelConfig(
        family="mixtral", vocab_size=32000, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, intermediate_size=14336,
        max_seq_len=8192, rope_theta=1000000.0, num_experts=8,
        experts_per_token=2),
    # --- chip-fitting MoE bench pair (BASELINE.json config 4 at a scale
    # a single 16 GB chip holds: ~0.8 B params bf16).  The -dense twin
    # has the SAME active FLOPs per token (top-2 of 8 experts = 2x the
    # expert intermediate, dense I = 2 x 3584) so moe-vs-dense decode
    # tok/s isolates the routing/dispatch cost. ---
    "mixtral-tpu-1b": ModelConfig(
        family="mixtral", vocab_size=32000, hidden_size=1024, num_layers=8,
        num_heads=16, num_kv_heads=4, intermediate_size=3584,
        max_seq_len=2048, rope_theta=1000000.0, num_experts=8,
        experts_per_token=2),
    "mixtral-tpu-1b-dense": ModelConfig(
        family="llama", vocab_size=32000, hidden_size=1024, num_layers=8,
        num_heads=16, num_kv_heads=4, intermediate_size=7168,
        max_seq_len=2048, rope_theta=1000000.0),
    # --- tiny configs for tests and virtual-mesh dry runs ---
    "llama-test": ModelConfig(
        family="llama", vocab_size=256, hidden_size=64, num_layers=4,
        num_heads=4, num_kv_heads=2, intermediate_size=128, max_seq_len=128,
        dtype_name="float32"),
    "qwen2-test": ModelConfig(
        family="qwen2", vocab_size=256, hidden_size=64, num_layers=4,
        num_heads=4, num_kv_heads=2, intermediate_size=128, max_seq_len=128,
        attn_qkv_bias=True, dtype_name="float32"),
    "gemma-test": ModelConfig(
        family="gemma", vocab_size=256, hidden_size=64, num_layers=4,
        num_heads=4, num_kv_heads=1, intermediate_size=128, max_seq_len=128,
        tie_embeddings=True, head_dim_override=32, embed_scale=True,
        mlp_act="gelu_tanh", norm_eps=1e-6, dtype_name="float32"),
    "bloom-test": ModelConfig(
        family="bloom", vocab_size=256, hidden_size=64, num_layers=4,
        num_heads=4, num_kv_heads=4, intermediate_size=256, max_seq_len=128,
        use_alibi=True, use_rope=False, attn_layernorm=True,
        tie_embeddings=True, dtype_name="float32"),
    "mixtral-test": ModelConfig(
        family="mixtral", vocab_size=256, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, intermediate_size=128, max_seq_len=128,
        num_experts=4, experts_per_token=2, dtype_name="float32"),
}


def get_model_config(name: str) -> ModelConfig:
    """Resolve a model name; an ``-int8`` / ``-int4`` suffix selects
    weight-only quantization (the reference's quantized exports,
    ``data/Data.kt:19-33``, as a runtime transform — ops/quant.py; int4
    is group-wise and packs two weights per byte)."""
    base = name
    quant = "none"
    for suffix in ("-int8", "-int4"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            quant = suffix[1:]
            break
    if base not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    cfg = MODEL_REGISTRY[base]
    if quant != "none":
        cfg = cfg.replace(quantization=quant)
    return cfg


def get_model_family(name: str) -> str:
    return get_model_config(name).family
