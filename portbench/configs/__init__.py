"""Configuration builders, one per configuration, beside its sizes file."""
