"""Model substrate of the port: context/policy, attention, MLP, the
decoder LM and the per-architecture dispatch."""
