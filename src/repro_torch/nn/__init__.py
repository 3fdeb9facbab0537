"""Neural-network blocks of the dense decoder: norms and RoPE, the gated
MLP, GQA attention over the paged KV cache, and the attention-backend
registry."""
