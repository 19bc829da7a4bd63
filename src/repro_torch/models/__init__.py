"""The dense decoder-only LM and the hybrid RG-LRU LM of the reference's
model stack, in PyTorch: `config` (ModelConfig, reduced), `layers` (norms,
RoPE, attention, MLP, unembedding), `lm` (init, forward, prefill, decode),
`hybrid` (init, forward), `registry` (get_family) and `convert`
(parameters carried over from the JAX package)."""
