"""The port's model substrate: config, layers, the MoE, Mamba2 and xLSTM
mixers, the stacked transformer and the :class:`~repro_torch.models.api.Model`
API (every family of the ten configs)."""
