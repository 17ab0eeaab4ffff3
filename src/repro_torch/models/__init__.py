"""The LM scaffolding's models: configuration, registry, layers and the
transformer (dense and vlm families)."""
