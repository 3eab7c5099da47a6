"""Matrix generators, one module a kind, found by the ``generator`` key of
a configuration file.  Each has ``build(cfg, seed, device) -> Matrix``; the
structure comes from the configuration alone, so every seed of a cell
does the same work."""
