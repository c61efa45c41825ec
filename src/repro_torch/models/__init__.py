"""Layer library of the port (the linear layer of ``repro.models.nn``)."""
