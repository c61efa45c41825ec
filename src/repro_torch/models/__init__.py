"""The LM zoo of the port (``repro.models``): configuration, layers,
attention, the Griffin recurrent block, assembly, the public ``Model``
and the parameters carried across from the JAX package."""
