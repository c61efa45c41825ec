"""PyTorch port of the Perona fingerprinting system (``repro``).

The subpackages keep the names of their counterparts in ``repro``. The
numpy data layer (``fingerprint``, ``core.preprocess``,
``core.graph_data``, ``core.ranking``, ``fleet.store``,
``fleet.drift``) is a copy of the reference; the model, the scoring
engine and the watchdog are PyTorch, and the edge-softmax aggregation
runs as a hand-written CUDA kernel (``kernels.edge_softmax``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
Nothing here imports JAX or ``repro``.
"""
