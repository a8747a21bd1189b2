"""The LM scaffold's models: the JAX package's ``models/`` as ``nn.Module``s
(forward only), built from the same ParamSpec trees."""
