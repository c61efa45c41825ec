"""PyTorch port of the Perona fingerprinting system (``repro``).

The subpackages keep the names of their counterparts in ``repro``. The
numpy data layer (``fingerprint``, ``core.preprocess``,
``core.graph_data``, ``core.ranking``, ``fleet.store``,
``fleet.drift``) is a copy of the reference; the Perona model, the
scoring engine and the watchdog are PyTorch, and so is RecurrentGemma
serving (``models``, ``configs``, ``launch.serve``). The Pallas kernels
on those paths run as hand-written CUDA kernels: edge-softmax
aggregation, flash attention and the RG-LRU scan (``kernels``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
Nothing here imports JAX or ``repro``.
"""
