"""Model configurations of the LM scaffolding, one module per architecture
(copies of the JAX package's ``configs``, importing the port's
:class:`~repro_torch.models.config.ModelConfig`)."""
