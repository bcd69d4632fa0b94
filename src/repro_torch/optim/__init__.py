"""Optimizers of the port: AdamW over parameter trees of tensors."""
