"""TopK sparse autoencoder (per-timestep variant)."""
