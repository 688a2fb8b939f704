"""Random keys and token samplers (port of ``repro.sampling``)."""
