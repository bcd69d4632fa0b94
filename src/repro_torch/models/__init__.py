"""The port's model substrate: config, layers, the stacked transformer and
the :class:`~repro_torch.models.api.Model` API (dense family)."""
