"""The LM scaffold's models: the JAX package's ``models/`` as ``nn.Module``s,
built from the same ParamSpec trees, with the reference's training backward
(the flash attention's custom backward, per-layer recompute in ``loss``)."""
