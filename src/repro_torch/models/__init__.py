"""The reference's model stack, in PyTorch: `config` (ModelConfig,
reduced), `layers` (norms, RoPE, attention, cross attention, the causal
conv, MLP, unembedding), the family modules `lm` (dense, moe, vlm), `moe`,
`xlstm`, `hybrid` and `encdec`, `registry` (get_family) and `convert`
(parameters carried over from the JAX package)."""
