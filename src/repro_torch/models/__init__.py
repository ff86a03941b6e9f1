"""The LM stack's model: layers, the RG-LRU block, ``Model`` (block types
``attn``, ``local`` and ``rg``) and the converter from the JAX package's
parameter and cache trees."""
