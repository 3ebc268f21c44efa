"""Waveform augmentation on the device (RawBoost)."""
