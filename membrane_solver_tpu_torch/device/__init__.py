"""Device layer: compiled problem state and mesh geometry on tensors."""
