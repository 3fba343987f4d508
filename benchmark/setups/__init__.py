"""How a configuration's index is set up, one module a configuration's
`setup` name (single.py without the key, segments.py); the registry finds
them by name."""
